"""Convert a checkpoint to the port's ``.pth`` (twin of
``tools/convert_reference_ckpt.py``):

    python -m lvc_tpu_torch.tools.convert_reference_ckpt \\
        --src model_final.ckpt --dst model_final.pth \\
        --config-file configs/COCO-detection/faster_rcnn_R_50_FPN_base.yaml

``--src`` is a JAX checkpoint (``.ckpt``, flax msgpack: a whole
``TrainState`` from the JAX trainer or the variables-only file of JAX's
converter), a ``.pth`` (``torch.save``) or a detectron2 ``.pkl``. A ``.ckpt``
is read with ``msgpack`` and numpy alone (no flax) and its variables are
mapped to detectron2 names by ``checkpoint.convert.from_flax``; ``.pth`` and
``.pkl`` files already hold those names (their entries that are no weights,
``checkpointer.IGNORED_KEYS``, are dropped). With ``--config-file`` (and
``KEY VALUE`` overrides) every key and shape is checked strictly against the
model ``build_model(cfg)`` builds on the meta device (no weights
materialised): a missing or unexpected key fails unless ``--allow-partial``,
a shape mismatch always. A norm entry counts only where it fills a norm of
its own flax kind (``checkpointer.misplaced_norms``): as in JAX's converter,
whose ``torch_to_flax`` names every ``.norm`` FrozenBN, a detectron2
``.pth``/``.pkl`` fills no SyncBN norm, its entries there unexpected and
those norms missing. The output ``{"model": state_dict, "norms",
"iteration": 0}`` keeps the source's norm kinds and loads with
``MODEL.WEIGHTS``, as the trainer's checkpoints do.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help=".ckpt (JAX), .pth (torch.save) or .pkl (d2 zoo) checkpoint")
    ap.add_argument("--dst", required=True, help="output .pth")
    ap.add_argument("--config-file", default="", help="validate keys/shapes against the model this config builds")
    ap.add_argument(
        "--allow-partial", action="store_true",
        help="with --config-file: tolerate missing/unexpected keys (shape mismatches always fail)",
    )
    ap.add_argument("opts", nargs="*", default=[], help="config overrides (KEY VALUE ...) applied after --config-file")
    return ap.parse_args(argv)


def validate_against_config(
    sd: Dict[str, torch.Tensor], norms: Dict[str, str], config_file: str, opts: List[str], allow_partial: bool
) -> bool:
    """Every key and shape of ``sd`` (its norm kinds ``norms``) against the
    config's model (built on the meta device); prints each fault, returns
    whether it passes."""
    from lvc_tpu_torch.checkpoint.checkpointer import misplaced_norms
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model

    cfg = get_cfg()
    cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(opts)
    with torch.device("meta"):
        model = build_model(cfg, device="meta")
    want = model.state_dict()
    misplaced = misplaced_norms(model, norms).keys()
    ok = True
    for k in sorted(want.keys() - (sd.keys() - misplaced)):
        print(f"[convert] missing in checkpoint: {k}")
        ok = ok and allow_partial
    for k in sorted((sd.keys() - want.keys()) | misplaced):
        print(f"[convert] unexpected in checkpoint: {k}")
        ok = ok and allow_partial
    for k in sorted(want.keys() & (sd.keys() - misplaced)):
        ws, hs = tuple(want[k].shape), tuple(sd[k].shape)
        if ws != hs:
            print(f"[convert] SHAPE MISMATCH {k}: ckpt {hs} vs model {ws}")
            ok = False
    return ok


def main(argv=None) -> int:
    from lvc_tpu_torch.checkpoint.checkpointer import IGNORED_KEYS, read_checkpoint

    args = parse_args(argv)
    sd, norms = read_checkpoint(args.src)
    sd = {k: v for k, v in sd.items() if not any(s in k for s in IGNORED_KEYS)}
    n_params = sum(v.numel() for v in sd.values())
    print(f"[convert] {args.src}: {len(sd)} tensors, {n_params / 1e6:.1f} M values")
    if args.config_file:
        if not validate_against_config(sd, norms, args.config_file, args.opts, args.allow_partial):
            print("[convert] validation FAILED (see messages above); "
                  "use --allow-partial to write anyway with missing/extra keys")
            return 1
        print("[convert] validation OK against", args.config_file)
    os.makedirs(os.path.dirname(os.path.abspath(args.dst)), exist_ok=True)
    torch.save({"model": sd, "norms": norms, "iteration": 0}, args.dst)
    print(f"[convert] wrote {args.dst} ({os.path.getsize(args.dst) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
