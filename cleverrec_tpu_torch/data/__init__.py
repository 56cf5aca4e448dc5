from cleverrec_tpu_torch.data.dataset import RankingData, load_ranking_data  # noqa: F401
from cleverrec_tpu_torch.data.arrays import DeviceData, build_device_data  # noqa: F401
