from midas_tpu_torch.db.layout import Database, check_database
from midas_tpu_torch.db.refpack import ReferencePack, build_pack
from midas_tpu_torch.db.index import SeedIndex, build_seed_index
