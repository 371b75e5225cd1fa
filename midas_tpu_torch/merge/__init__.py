from midas_tpu_torch.merge.core import Sample, SpeciesGroup, select_species
