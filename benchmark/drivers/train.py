"""A training cell: the program's training step, fed from a pool of
device-resident batches or from the program's own train loader, timed over
a window of whole steps; the first steps are the ones the reference
follows. With ``traffic.ranks`` > 1 the step is the program's data-parallel
step (``make_data_parallel_train_step``), one process a card through the
program's ``engine/launch.py``, each rank fed its share of every global
batch; rank 0 reports, with the banned modules (``benchmark.run.BANNED``)
that any rank loaded, and the reference holds the global step to one
process's step on the union of the ranks' images.

Cell keys: ``traffic`` (``feed`` "device" or "loader", ``batch`` (global),
``ranks``, and the generator's parameters), ``check_steps`` (the first steps
the reference follows), ``trace_steps`` (the traced section's steps),
``limits``.
"""
from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from benchmark import program
from benchmark.reference import boxes as bx
from benchmark.reference import train as ref_train
from benchmark.reference import weights as ref_weights
from benchmark.traffic.images import make_pool


VOTE_EVERY = 8


class DeviceFeed:
    """The pool's batches in turn; each rank takes its rows of each."""

    def __init__(self, pool: List[Dict], rank: int = 0, world: int = 1):
        self.pool = pool
        self.shares = [{k: v[rank * (v.shape[0] // world):(rank + 1) * (v.shape[0] // world)] for k, v in b.items()}
                       for b in pool]
        self.i = 0
        self.waits: List[float] = []
        self.traced = False

    def next(self):
        j = self.i % len(self.pool)
        self.i += 1
        return self.shares[j], None, self.pool[j]

    def stop(self):
        pass

    def close(self):
        pass


class LoaderFeed:
    """The program's train loader on a JPEG tree written under TMPDIR; each
    batch moves to the device as the trainer moves it."""

    def __init__(self, cfg, cell: Dict, seed: int, device):
        from lvc_tpu_torch.data.build import build_detection_train_loader
        from lvc_tpu_torch.data.catalog import DatasetCatalog

        from benchmark.traffic.tree import write_tree

        self.root = tempfile.mkdtemp(prefix="bench_tree_")
        self.dicts = write_tree(self.root, cell["traffic"], cfg.MODEL.ROI_HEADS.NUM_CLASSES, seed)
        name = f"bench_tree_{os.getpid()}_{id(self)}"
        dicts = self.dicts
        DatasetCatalog.register(name, lambda: [dict(d, annotations=list(d["annotations"])) for d in dicts])
        cfg.DATASETS.TRAIN = (name,)
        cfg.SEED = seed % (2 ** 31)
        self.device = device
        self.it = iter(build_detection_train_loader(cfg))
        self.waits: List[float] = []
        self.traced = False  # in the traced section the wait is a profiler range

    def next(self):
        t0 = time.perf_counter()
        if self.traced:
            with record_function("loader_wait"):
                host = next(self.it)
        else:
            host = next(self.it)
        self.waits.append(time.perf_counter() - t0)
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        return batch, host, batch

    def stop(self):
        """Ends the loader's prefetch (its thread pool shuts down)."""
        self.it.close()

    def close(self):
        shutil.rmtree(self.root, ignore_errors=True)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def _to(v, device):
    if isinstance(v, list) and v and torch.is_tensor(v[0]):
        return [t.to(device) for t in v]
    return v.to(device) if torch.is_tensor(v) else v


def _cat_calls(per_rank: List[Dict]) -> Dict:
    """One capture of the global batch from the ranks' captures, in rank
    order (image i of rank r is global image r * B_local + i)."""
    out = {"grids": per_rank[0]["grids"]}
    for k, v in per_rank[0].items():
        if k == "grids":
            continue
        if isinstance(v, list):
            out[k] = [torch.cat([c[k][j] for c in per_rank]) for j in range(len(v))]
        else:
            out[k] = torch.cat([c[k] for c in per_rank])
    return out


def run(cell: Dict, config: Dict, seed: int, seconds: float, trace: bool, device, overrides=None, faults=None,
        kernels=()):
    """One run of a training cell: a dict with ``setup_done`` (the wall time
    of the first timed step), ``setup_marks``, ``window`` (seconds, steps,
    images, flops, peak_flops, loader_waits), ``trace``, ``traced_steps``,
    ``kernel_least_ms`` (of the declared ``kernels``), ``memory_peak_bytes``,
    ``numbers`` (the comparison), ``attempted``/``failed``, ``e2e`` and, on
    more than one rank, ``banned`` (what the ranks loaded of
    ``benchmark.run.BANNED``). ``faults`` (tests) breaks the timed path
    underneath."""
    world = cell["traffic"].get("ranks", 1)
    if world == 1:
        return run_rank(cell, config, seed, seconds, trace, device, overrides, faults, kernels)
    from lvc_tpu_torch.engine.launch import launch

    outdir = tempfile.mkdtemp(prefix="bench_ranks_")
    try:
        devices = [f"cuda:{r}" for r in range(world)] if device.type == "cuda" else ["cpu"] * world
        launch(_rank_main, world, args=(cell, config, seed, seconds, trace, overrides, faults, list(kernels), outdir),
               devices=devices)
        return torch.load(os.path.join(outdir, "rank0.pt"), weights_only=False)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def _rank_main(cell, config, seed, seconds, trace, overrides, faults, kernels, outdir):
    import torch.distributed as dist

    from benchmark.run import banned_modules

    device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu")
    out = run_rank(cell, config, seed, seconds, trace, device, overrides, faults, kernels)
    loaded = [None] * dist.get_world_size()
    dist.all_gather_object(loaded, banned_modules())
    if dist.get_rank() == 0:
        out["banned"] = sorted(set().union(*loaded))
        torch.save(out, os.path.join(outdir, "rank0.pt"))


def run_rank(cell: Dict, config: Dict, seed: int, seconds: float, trace: bool, device, overrides=None,
             faults=None, kernels=()) -> Optional[Dict]:
    """The run on this process's card; in a data-parallel run every rank
    calls it and rank 0 returns the result (the others None)."""
    import torch.distributed as dist

    from benchmark import counts
    from benchmark.check import program_readings
    from benchmark.trace import Profile

    marks = [("imports", time.time())]
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if world > 1 else 0
    cfgd = dict(config["cfg"], **(overrides or {}))
    cfg = program.port_cfg(config, overrides)
    traffic = cell["traffic"]
    weights = ref_weights.make(cfgd, bx.fold_in(seed, 1), device)
    model = program.build_model(cfg, weights, device)
    marks.append(("model and weights", time.time()))
    p0 = {k: v.detach().clone() for k, v in weights.items() if ref_train.trainable(cfgd, k)}
    del weights
    step, optimizer = program.build_train_step(cfg, model, data_parallel=world > 1)
    if faults:
        step = faults.wrap_step(step, model, optimizer)
    if traffic["feed"] == "loader":
        feed = LoaderFeed(cfg, cell, seed, device)
    else:
        feed = DeviceFeed(make_pool(traffic, cfgd, bx.fold_in(seed, 2), device), rank, world)

    def step_seed(i: int) -> int:
        return bx.fold_in(seed, 3, i)

    names = {id(p): n for n, p in model.named_parameters()}
    marks.append(("step and traffic", time.time()))

    # set-up: the first steps, which the reference follows, until every
    # canvas has been run
    capture = program.Capture(model)
    n_check = cell["check_steps"]
    check_batches, check_host, captures, losses, grad_norms, update_norms = [], [], [], [], {}, {}
    canvases, i = set(), 0
    while i < n_check or (len(canvases) < len(set(traffic["canvases"])) and i < 4 * n_check):
        batch, host, whole = feed.next()
        canvases.add(tuple(batch["image"].shape[1:3]))
        if i < n_check:
            capture.begin()
        metrics = step(batch, step_seed(i))
        capture.end()
        if i < n_check:
            losses.append({k: float(v) for k, v in metrics.items()})
            captures.append({k: _to(v, "cpu") for k, v in capture.calls[-1].items()})
            capture.calls.clear()
            check_batches.append(whole if host is None else None)
            check_host.append(host)
        if i == 0:
            grad_norms = _norms({names[id(p)]: st["momentum_buffer"] for p, st in optimizer.state.items()})
        if i == n_check - 1:
            params = dict(model.named_parameters())
            update_norms = _norms({k: params[k].detach() - p0[k] for k in p0})
            del p0
        i += 1
    capture.remove()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    # the window: whole steps until ``seconds`` have passed (in a
    # data-parallel run rank 0's clock decides, and the ranks agree on it
    # every VOTE_EVERY steps, so they stop after the same step)
    B = traffic["batch"]
    setup_done = time.time()
    marks.append(("first steps", setup_done))
    flops = 0.0
    t0 = time.perf_counter()
    steps = 0
    feed.waits.clear()
    stop = torch.zeros(1, device=device)
    ends = [t0]
    while True:
        if world > 1:
            if steps % VOTE_EVERY == 0:
                stop.fill_(float(rank == 0 and time.perf_counter() - t0 >= seconds))
                dist.all_reduce(stop, op=dist.ReduceOp.MAX)
                if stop.item():
                    break
        elif time.perf_counter() - t0 >= seconds:
            break
        batch, _, _ = feed.next()
        step(batch, step_seed(i))
        H, W = batch["image"].shape[1:3]
        flops += B * counts.model_flops(cfgd, H, W, train=True)
        i += 1
        steps += 1
        ends.append(time.perf_counter())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    if rank == 0:
        print_steps(ends)
    peak, _ = counts.peak_flops(cfgd, train=True)
    window = {"seconds": window_s, "steps": steps, "images": steps * B, "flops": flops, "peak_flops": peak * world,
              "loader_waits": list(feed.waits) if traffic["feed"] == "loader" else None}

    summary, kc, traced = None, None, 0
    if trace:
        feed.traced = True
        with program.KernelCalls(kernels) as kc, Profile(program.RANGES_TRAIN) as prof:
            for _ in range(cell["trace_steps"]):
                batch, _, _ = feed.next()
                step(batch, step_seed(i))
                i += 1
                traced += 1
        summary = prof.summary
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    least_ms = kc.least_ms() if kc is not None else {}
    del kc
    feed.stop()
    if world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, {"captures": captures, "peak": memory_peak, "trace": summary})
        if rank != 0:
            return None
        captures = [_cat_calls([g["captures"][s] for g in gathered]) for s in range(n_check)]
        memory_peak = max(g["peak"] for g in gathered)
        if summary:
            traces = [g["trace"] for g in gathered]
            summary = dict(summary, busy_s=sum(t["busy_s"] for t in traces) / world)
            exposed = [t["nccl_exposed_ms"] for t in traces if t["nccl_exposed_ms"] is not None]
            summary["nccl_exposed_ms"] = sum(exposed) / len(exposed) if exposed else None

    # the program's readings, then its state is freed and the reference runs
    batches = [b if h is None else {k: torch.from_numpy(v).to(device) for k, v in h.items()}
               for b, h in zip(check_batches, check_host)]
    readings = program_readings(cfgd, [{k: _to(v, device) for k, v in c.items()} for c in captures], batches,
                                losses, grad_norms, update_norms)
    del model, optimizer, step, capture
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        numbers = _reference(cfgd, seed, device, batches, [step_seed(j) for j in range(n_check)], readings)
        if traffic["feed"] == "loader":
            from benchmark.check import loader_mismatch

            numbers["loader_mismatch"] = sum(loader_mismatch(h, feed.dicts, cfgd) for h in check_host)
    finally:
        feed.close()
    return {"setup_done": setup_done, "setup_marks": marks, "window": window, "trace": summary, "traced_steps": traced,
            "kernel_least_ms": least_ms, "memory_peak_bytes": memory_peak, "numbers": numbers,
            "attempted": steps, "failed": 0, "e2e": {"train_img_per_s": window["images"] / window_s}}


def print_steps(ends: List[float]) -> None:
    """The window's step times on standard error: whether it ran steady."""
    ms = [1e3 * (b - a) for a, b in zip(ends[:-1], ends[1:])]
    if ms:
        q = sorted(ms)
        print(f"window: {len(ms)} steps, ms median {q[len(q) // 2]:.1f}, min {q[0]:.1f}, max {q[-1]:.1f}; "
              f"first {[round(t, 1) for t in ms[:6]]}, last {[round(t, 1) for t in ms[-6:]]}", file=sys.stderr)


def _reference(cfgd, seed, device, batches, seeds, readings) -> Dict[str, float]:
    from benchmark.check import train_reference

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        params0 = ref_weights.make(cfgd, bx.fold_in(seed, 1), device)
        return train_reference(cfgd, params0, batches, seeds, readings)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
