from lvc_tpu_torch.model_zoo.model_zoo import get, get_checkpoint_url, get_config_file  # noqa: F401
