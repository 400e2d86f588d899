"""The port stands alone: importing it and building a model (the detector, the
box corrector, the proposal network, the cosine fine-tune detector, the verifier
ViT and the CLIs, the LVC chain's included, and the data-parallel layer:
``utils/comm.py``, ``engine/launch.py``, the DDP step, and the export, model
zoo, TTA, converter and utils modules) pulls in neither jax nor the JAX
package (nor ``__graft_entry__``), no file of the port (or chip_smoke.py) imports them,
and without a GPU the entry points refuse to run unless asked for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "lvc_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "lvc_tpu", "__graft_entry__"), f"{path}: imports {name}"


def test_import_and_build_leave_jax_out():
    code = (
        "import sys\n"
        "import lvc_tpu_torch\n"
        "from lvc_tpu_torch.config import get_cfg\n"
        "from lvc_tpu_torch.modeling.meta_arch.build import build_model\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/Base-RCNN-FPN.yaml')\n"
        "cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64; cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16\n"
        "build_model(cfg, device='cpu')\n"
        "cfg = get_cfg(); cfg.merge_from_file('configs/COCO-detection/cascade_ubbr_R_50_FPN_base.yaml')\n"
        "cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64; cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16\n"
        "build_model(cfg, device='cpu')\n"
        "cfg.MODEL.META_ARCHITECTURE = 'ProposalNetwork'; build_model(cfg, device='cpu')\n"
        "cfg = get_cfg()\n"
        "cfg.merge_from_file('configs/COCO-detection/faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml')\n"
        "cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64; cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16\n"
        "build_model(cfg, device='cpu')\n"
        "import lvc_tpu_torch.tools.run_nearest_neighbours\n"
        "import lvc_tpu_torch.tools.train_net_reg, lvc_tpu_torch.tools.train_net_reg_qe\n"
        "import lvc_tpu_torch.tools.coco_full_run, lvc_tpu_torch.tools.ckpt_surgery\n"
        "import lvc_tpu_torch.tools.create_coco_dataset_from_dets_all, lvc_tpu_torch.tools.train_net_qe_ig\n"
        "import lvc_tpu_torch.tools.combine_ubbr_with_qe, lvc_tpu_torch.tools.combine_pseudo_with_ignore\n"
        "import lvc_tpu_torch.tools.combine_qe_with_base\n"
        "from lvc_tpu_torch.utils import comm\n"
        "from lvc_tpu_torch.engine.launch import launch\n"
        "from lvc_tpu_torch.engine.train_loop import make_data_parallel_train_step\n"
        "from lvc_tpu_torch.ops.knn import sharded_knn_vote\n"
        "from lvc_tpu_torch.pipeline.verification import build_dino\n"
        "build_dino('dino_vits16', device='cpu')\n"
        "import lvc_tpu_torch.export, lvc_tpu_torch.model_zoo, lvc_tpu_torch.modeling.test_time_augmentation\n"
        "import lvc_tpu_torch.tools.convert_reference_ckpt\n"
        "from lvc_tpu_torch.utils import analysis, colormap, env, file_io, logger, memory, registry, serialize\n"
        "from lvc_tpu_torch.utils import video_visualizer, visualizer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'lvc_tpu', '__graft_entry__')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_cuda_default_raises_without_gpu(monkeypatch):
    from lvc_tpu_torch.modeling.meta_arch.build import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
