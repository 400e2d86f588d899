from lvc_tpu_torch.structures.image_list import ImageList, pad_to_divisibility  # noqa: F401
