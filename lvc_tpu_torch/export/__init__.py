from lvc_tpu_torch.export.api import (  # noqa: F401
    export_model,
    export_stablehlo_text,
    load_exported,
    save_exported,
)
