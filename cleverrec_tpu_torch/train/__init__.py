from cleverrec_tpu_torch.train.trainer import Trainer  # noqa: F401
