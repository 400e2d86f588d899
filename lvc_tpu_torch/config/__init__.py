from lvc_tpu_torch.config.config import CfgNode, get_cfg, global_cfg, set_global_cfg  # noqa: F401
