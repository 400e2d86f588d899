"""The port's operators. Importing the package registers the custom ops
``lvc_tpu_torch::{roi_align_band_fwd, roi_align_paired_fwd,
matmul_affine_residual, flash_attention_fwd, nms_fixpoint}``, which a program
exported by ``torch.export`` calls: import it before ``torch.export.load``."""
from lvc_tpu_torch.ops import attention, fused_matmul, nms, roi_align  # noqa: F401
