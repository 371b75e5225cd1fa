from midas_tpu_torch.testkit.simulate import (SimulatedCommunity, simulate_db,
                                              simulate_paired_reads,
                                              simulate_reads)
