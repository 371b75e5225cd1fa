from midas_tpu_torch.dbbuild.build_db import run_build
from midas_tpu_torch.dbbuild.cluster import greedy_cluster
