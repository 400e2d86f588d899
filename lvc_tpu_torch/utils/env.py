"""Environment helpers (counterpart of ``lvc_tpu/utils/env.py``;
detectron2/utils/env.py seed_all_rng and collect_env.py), for the PyTorch
and CUDA stack."""
from __future__ import annotations

import datetime
import os
import random
import shutil
import subprocess
import sys

import numpy as np


def seed_all_rng(seed: int | None = None) -> int:
    """Seed numpy, Python and torch's global generators; returns the seed
    (env.py:seed_all_rng)."""
    import torch

    if seed is None:
        seed = (
            os.getpid()
            + int(datetime.datetime.now().strftime("%S%f"))
            + int.from_bytes(os.urandom(2), "big")
        )
    seed = int(seed) % (2 ** 31)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    return seed


def _nvcc_version() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        return "not found"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip().splitlines()
    return out[-1] if out else "unknown"


def collect_env_info() -> str:
    """Human-readable environment report (collect_env.py): Python, numpy,
    torch and the CUDA it was built with, nvcc, triton and the cards."""
    import torch

    lines = [
        f"sys.platform: {sys.platform}",
        f"python: {sys.version.splitlines()[0]}",
        f"numpy: {np.__version__}",
        f"torch: {torch.__version__}",
        f"torch CUDA: {torch.version.cuda}",
        f"nvcc: {_nvcc_version()}",
    ]
    try:
        import triton

        lines.append(f"triton: {triton.__version__}")
    except ImportError:
        lines.append("triton: not installed")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            lines.append(f"GPU {i}: {p.name}, {p.total_memory / 2 ** 30:.1f} GiB, sm_{p.major}{p.minor}")
    else:
        lines.append("GPU: none available")
    lines.append(f"CUDA_VISIBLE_DEVICES: {os.environ.get('CUDA_VISIBLE_DEVICES', '')}")
    return "\n".join(lines)
