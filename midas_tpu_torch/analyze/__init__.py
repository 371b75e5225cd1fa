from midas_tpu_torch.analyze.parse_snps import SnpMatrix, fetch_samples, fetch_sites
