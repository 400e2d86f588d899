"""The canonical end-to-end COCO 30-shot LVC run in the port: the twin of
``scripts/coco_full_run.sh`` (the reference's 18-command chain), the same
steps through the port's tools with ``.pth`` checkpoints in place of
``.ckpt`` and the same output paths and file names:

    python -m lvc_tpu_torch.tools.coco_full_run --datasets datasets --weights R-50.pth

Each step runs in this process, as ``python -m lvc_tpu_torch.tools.<tool>
<argv>`` would (the command is printed before it runs), from the files the
steps before it wrote under ``checkpoints/coco/`` in the working directory.
The configs are those of ``configs/`` as they stand.

- ``--datasets``: the root of the COCO tree (``$DETECTRON2_DATASETS``);
  every COCO split is registered on it.
- ``--iters``: ``SOLVER.MAX_ITER`` of every training step (default: each
  config's own).
- ``--weights``: the initial weights of steps 1 and 8, in place of the
  configs' ImageNet ``R-50.pkl``; ``--ubbr-weights`` those of step 8 alone.
- ``--num-gpus``: the ranks of every step that takes the training CLI's
  flags (the training, evaluation and verification tools), passed on as
  their ``--num-gpus``; each such step runs through ``engine/launch.py``
  (default 1: in this process).
- Trailing ``KEY VALUE`` pairs are config overrides for every step that
  reads a config (the training, evaluation and verification tools).

Neither trainer writes the ``model_final`` the script names (both save
``model_{iter:07d}`` and point ``last_checkpoint`` at the last), so after each
training step this twin links ``model_final.pth`` to that last checkpoint.
Run on the card by default; ``MODEL.DEVICE cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import importlib
import os
import shlex
from typing import List, NamedTuple, Optional, Sequence

from lvc_tpu_torch.data.builtin import register_all_coco
from lvc_tpu_torch.data.catalog import DatasetCatalog
from lvc_tpu_torch.engine.defaults import default_argument_parser
from lvc_tpu_torch.engine.launch import launch

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")
CKPT = "checkpoints/coco/faster_rcnn"
UBBR = "checkpoints/coco/cascade_ubbr"
BASE = f"{CKPT}/faster_rcnn_R_50_FPN_base"
NOVEL = f"{CKPT}/faster_rcnn_R_50_FPN_ft_novel_30shot"
FT = f"{CKPT}/faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout"
UBBR_BASE = f"{UBBR}/cascade_ubbr_R_50_FPN_base"
UBBR_FT = f"{UBBR}/cascade_ubbr_R_50_FPN_ft_all_30shot_aug_ftmore"
RETRAIN = f"{FT}/end_to_end_pseudo_annotations"
MINED = "_score_max10_min08_full_all"  # the mining steps' suffix for K-max 1.0, K-min 0.8, --full


class Step(NamedTuple):
    number: str  # the step of scripts/coco_full_run.sh, with its split where it loops
    tool: str  # the module under lvc_tpu_torch.tools
    argv: List[str]
    output_dir: Optional[str] = None  # a training step's OUTPUT_DIR, where model_final.pth goes


def _config(name: str) -> str:
    return os.path.join(CONFIGS, name)


# the tools that take default_argument_parser's flags, --num-gpus among them
LAUNCHED = ("train_net", "train_net_reg", "train_net_reg_qe", "run_nearest_neighbours", "train_net_qe_ig")


def chain(datasets: str, iters: Optional[int] = None, weights: Optional[str] = None,
          ubbr_weights: Optional[str] = None, opts: Sequence[str] = (), num_gpus: int = 1) -> List[Step]:
    """The 18 steps of ``scripts/coco_full_run.sh`` in order, each step of a
    ``LAUNCHED`` tool with ``--num-gpus num_gpus``."""
    opts = list(opts)
    train = opts + (["SOLVER.MAX_ITER", str(iters)] if iters else [])
    init = ["MODEL.WEIGHTS", weights] if weights else []
    ubbr_init = ["MODEL.WEIGHTS", ubbr_weights] if ubbr_weights else init
    base_yaml = ["--config-file", _config("COCO-detection/faster_rcnn_R_50_FPN_base.yaml")]
    novel_yaml = ["--config-file", _config("COCO-detection/faster_rcnn_R_50_FPN_ft_novel_30shot.yaml")]
    ft_yaml = ["--config-file", _config("COCO-detection/faster_rcnn_R_50_FPN_ft_all_30shot_aug_ftmore_dropout.yaml")]
    ubbr_base_yaml = ["--config-file", _config("COCO-detection/cascade_ubbr_R_50_FPN_base.yaml")]
    ubbr_ft_yaml = ["--config-file", _config("COCO-detection/cascade_ubbr_R_50_FPN_ft_all_30shot_aug_ftmore.yaml")]
    proposals = ["DATASETS.TEST", "('coco_test_all', 'coco_trainval_all',)",
                 "MODEL.META_ARCHITECTURE", "ProposalNetwork"]
    inference = f"{FT}/inference/coco_instances_{{}}_results"
    mine = ["--gt-data", "coco_trainval_all_30shot", "--full", "--K-min", "0.8", "--K-max", "1.0"]
    # the verifier names its output after its model (the verify config's dino_vits8 unless overridden)
    nn_model = next((v for k, v in zip(opts, opts[1:]) if k == "QUERY_EXPAND.NN_MODEL"), "dino_vits8")
    verified = f"{MINED}_{nn_model}_10_cosine"

    steps = [
        # baseline (TFA-style) training
        Step("1", "train_net", base_yaml + train + init, BASE),
        Step("2", "ckpt_surgery", ["--method", "remove", "--coco", "--src1", f"{BASE}/model_final.pth",
                                   "--save-dir", f"{BASE}/"]),
        Step("3", "train_net", novel_yaml + train, NOVEL),
        Step("4", "ckpt_surgery", ["--method", "combine", "--coco", "--src1", f"{BASE}/model_final.pth",
                                   "--src2", f"{NOVEL}/model_final.pth", "--save-dir", f"{NOVEL}/"]),
        Step("5", "train_net", ft_yaml + train, FT),
        # box corrector training
        Step("6", "train_net", base_yaml + ["--resume", "--eval-only"] + opts + proposals),
        Step("7", "train_net", ft_yaml + ["--resume", "--eval-only"] + opts + proposals),
        Step("8", "train_net_reg", ubbr_base_yaml + train + ubbr_init + [
            "DATASETS.PROPOSAL_FILES_TRAIN", f"('{BASE}/coco_proposals_trainval_results.pkl',)",
            "DATASETS.PROPOSAL_FILES_TEST", f"('{BASE}/coco_proposals_test_results.pkl',)"], UBBR_BASE),
        Step("9", "train_net_reg", ubbr_ft_yaml + train + [
            "DATASETS.PROPOSAL_FILES_TRAIN", f"('{FT}/coco_proposals_trainval_results.pkl',)",
            "DATASETS.PROPOSAL_FILES_TEST", f"('{FT}/coco_proposals_test_results.pkl',)"], UBBR_FT),
        # candidate sourcing (label)
        Step("10", "train_net", ft_yaml + ["--resume", "--eval-only"] + opts + [
            "DATASETS.TEST", "('coco_trainval_all', 'coco_unlabeled_all')"]),
        Step("11", "create_coco_dataset_from_dets_all", ["--json-data", "coco_trainval_all"] + mine + [
            "--dt-path", inference.format("trainval") + ".json"]),
        Step("12", "create_coco_dataset_from_dets_all", ["--json-data", "coco_unlabeled_all"] + mine + [
            "--dt-path", inference.format("unlabeled") + ".json"]),
        Step("13", "create_coco_dataset_from_dets_all", ["--json-data", "coco_unlabeled_all"] + mine + [
            "--dt-path", inference.format("unlabeled") + ".json", "--all-cats"]),
    ]
    # label verification (verify)
    for n, split in (("14", "trainval"), ("15", "unlabeled")):
        steps.append(Step(f"{n} {split}", "run_nearest_neighbours", [
            "--config-file", _config("LABEL-Verification/dino_label_verification.yaml"), "--eval-only"] + opts + [
            "DATASETS.DT_PATH", f"('{inference.format(split)}{MINED}.json',)",
            "QUERY_EXPAND.NN_DSET", "('coco_trainval_all_30shot',)", "QUERY_EXPAND.KNN", "10",
            "OUTPUT_DIR", FT]))
    # box correction (correct)
    for split in ("trainval", "unlabeled"):
        steps.append(Step(f"16 {split}", "train_net_reg_qe", ubbr_ft_yaml + ["--resume", "--eval-only"] + opts + [
            "DATASETS.DT_PATH", f"('{inference.format(split)}{verified}.json',)",
            "MODEL.META_ARCHITECTURE", "GeneralizedRCNNRegOnly", "QUERY_EXPAND.ENABLED", "True",
            "MODEL.LOAD_PROPOSALS", "False"]))
    # dataset sundries: corrected boxes by id, ignores, base annotations
    for split in ("trainval", "unlabeled"):
        path = inference.format(split) + verified
        steps.append(Step(f"17 {split}", "combine_ubbr_with_qe", [
            "--ubbr-data", f"{path}_ubbr.json", "--qe-data", f"{path}.json"]))
        steps.append(Step(f"17 {split}", "combine_pseudo_with_ignore", [
            "--ps-data", f"{path}_ubbr_id.json", "--ig-data", f"{inference.format(split)}{MINED}.json"]))
    steps.append(Step("17 trainval", "combine_qe_with_base", [
        "--ps-data", f"{inference.format('trainval')}{verified}_ubbr_id_ignore.json",
        "--bs-data", os.path.join(datasets, "cocosplit", "datasplit", "trainvalno5k.json")]))
    steps.append(Step("17 unlabeled", "combine_qe_with_base", [
        "--ps-data", f"{inference.format('unlabeled')}{verified}_ubbr_id_ignore.json",
        "--bs-data", f"{inference.format('unlabeled')}{MINED}_allcats.json", "--base-ignore"]))
    # end-to-end retrain on pseudo-annotations with ignore regions
    steps.append(Step("18", "train_net_qe_ig", ft_yaml + train + [
        "OUTPUT_DIR", RETRAIN, "MODEL.WEIGHTS", f"{FT}/model_final.pth",
        "DATASETS.DT_PATH",
        f"('{inference.format('trainval')}{verified}_ubbr_id_ignore_wbase.json', "
        f"'{inference.format('unlabeled')}{verified}_ubbr_id_ignore_wbase_base_ig.json')",
        "QUERY_EXPAND.ENABLED", "True", "MODEL.BACKBONE.FREEZE", "False"], RETRAIN))
    return [s._replace(argv=["--num-gpus", str(num_gpus)] + s.argv) if s.tool in LAUNCHED else s
            for s in steps]


def use_datasets(root: str) -> None:
    """Point ``$DETECTRON2_DATASETS`` at ``root`` and register every COCO
    split on it anew."""
    os.environ["DETECTRON2_DATASETS"] = root
    for name in DatasetCatalog.list():
        if name.startswith("coco_"):
            DatasetCatalog.remove(name)
    register_all_coco(root)


def link_model_final(output_dir: str) -> str:
    """``<output_dir>/model_final.pth`` as a hard link to the checkpoint that
    ``last_checkpoint`` names."""
    with open(os.path.join(output_dir, "last_checkpoint")) as f:
        last = os.path.join(output_dir, f.read().strip())
    final = os.path.join(output_dir, "model_final.pth")
    if os.path.lexists(final):
        os.remove(final)
    os.link(last, final)
    return final


def run_step(step: Step):
    """Run one step as its tool's command line would: through ``launch``
    for a ``LAUNCHED`` tool (in this process with one rank), else in this
    process. Returns what the tool's ``main`` returns in this process (None
    when it ran in spawned ranks)."""
    print(f"[coco_full_run] step {step.number}: python -m lvc_tpu_torch.tools.{step.tool} "
          f"{shlex.join(step.argv)}", flush=True)
    module = importlib.import_module(f"lvc_tpu_torch.tools.{step.tool}")
    if step.tool in LAUNCHED:
        a = default_argument_parser().parse_args(step.argv)
        result = launch(module.main, a.num_gpus, a.num_machines, a.machine_rank, a.dist_url, args=(a,))
    else:
        result = module.main(module.parser.parse_args(step.argv))
    if step.output_dir:
        link_model_final(step.output_dir)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description="The COCO 30-shot LVC chain of scripts/coco_full_run.sh")
    parser.add_argument("--datasets", default=os.getenv("DETECTRON2_DATASETS", "datasets"),
                        help="root of the COCO tree")
    parser.add_argument("--iters", type=int, default=None, help="SOLVER.MAX_ITER of every training step")
    parser.add_argument("--weights", default=None, help="initial weights of steps 1 and 8")
    parser.add_argument("--ubbr-weights", default=None, help="initial weights of step 8")
    parser.add_argument("--num-gpus", type=int, default=1, help="ranks of every launched step")
    parser.add_argument("opts", nargs=argparse.REMAINDER, help="config overrides for every config-driven step")
    args = parser.parse_args(argv)
    use_datasets(args.datasets)
    for step in chain(args.datasets, args.iters, args.weights, args.ubbr_weights, args.opts, args.num_gpus):
        run_step(step)


if __name__ == "__main__":
    main()
