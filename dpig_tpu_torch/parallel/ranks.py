"""World N against world 1: one step of the port on the N ranks of a
process group, each on its rows of one global input, with what each rank
computed brought back to the caller, who holds it against the same step
at world 1 on the whole input.

    outs = run("stage1", inputs, n=2)                      # gloo, CPU
    outs = run("stage1", inputs, n=2, platform="", backend="gloo")
                                                  # two ranks on one card

`inputs` holds CPU tensors and numpy batches: the weights every rank
starts from (`params`, a `bridge.params_from_flax` / `cpu_state()` state),
the global batch or batches, the global noise, and the Config fields
(`cfg`). Jobs:

  batchnorm  `models.layers.BatchNorm` inside `global_batch_stats`: two
             chained updating passes and the backward of sum(y * ct);
  stage1     one `Stage1App` train step (models 1 / 101, any --D_arch),
             recorded by `train.parity.recorded_train_step`;
  stage2     one Stage-II step (`cls`: Stage2AppApp, Stage2AppSingleApp,
             Stage2PoseApp), the rank's rows of the global noise;
  pose_ae    one `Stage1PoseApp` step (models 2 / 102);
  int8_transfer  a model-12 int8 batch: calibrated on the global batch
             (rank 0's tables given to every rank), served on the rank's
             rows;
  collectives  whether the backend takes the device's tensors for the
             collectives `dist` hands them to (gloo and CUDA tensors), and
             with `timed_numel` the ms of an all-reduce of that many
             float32 values.

For stage1, `float64=True` runs the step in float64
(`parity.to_float64`; `stem64=True` the embedding-stem sum too,
`outputs64=True` the nets' outputs and the losses), `local_grads=True`
also returns the gradients each rank computed before the all-reduce, and
`local_bn=True` normalizes the D by each rank's own batch statistics,
the fault a check of the global BatchNorm must see. For stage2,
`control=True` runs the step with the TF32 flags on and its body (critic
forwards, backward passes, updates) past the float32 guard, to show that
a check built on these records sees TF32.
`timed_steps` k adds k more steps after the recorded one, each timed
(`ms`, host clock around a synchronized step). Each rank returns a dict
of CPU tensors (a `StepRecord`'s fields for the train steps) and the
pose-kernel and s8-conv launches of the job. Any job may name the
fields it returns (`returns`), and with `lean=True` every rank returns
`digest`, a SHA-256 of its record's tensors, and only rank 0 the
tensors themselves (a full-width float64 record is ~2 GB a rank).
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import os
import sys
import tempfile
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dist, spawn

MODULE = "dpig_tpu_torch.parallel.ranks"


def run(job: str, inputs: Mapping, n: int, platform: str = "cpu",
        backend: Optional[str] = None, timeout: float = 300.0) -> List[Dict]:
    """Run `job` on n rank processes and return each rank's result, in
    rank order. Raises if a rank fails or the group outlasts `timeout` s
    (every rank is then ended)."""
    return run_many([(job, inputs)], n, platform, backend, timeout)[0]


def run_many(jobs: Sequence[Tuple[str, Mapping]], n: int,
             platform: str = "cpu", backend: Optional[str] = None,
             timeout: float = 300.0) -> List[List[Dict]]:
    """Run several (job, inputs) one after the other on the same n rank
    processes (one start-up, one process group) -> for each job, each
    rank's result."""
    with tempfile.TemporaryDirectory() as d:
        torch.save([(j, dict(i)) for j, i in jobs],
                   os.path.join(d, "inputs.pt"))
        port = dist.free_port()
        spawn.run_ranks(
            [spawn.python_argv(MODULE, str(r), str(n), str(port), d,
                               platform, backend or "") for r in range(n)],
            timeout)
        outs = [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    return [[o[j] for o in outs] for j in range(len(jobs))]


def local_batch(batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """This rank's rows of a global numpy batch."""
    return {k: dist.local_rows(torch.from_numpy(np.asarray(v))).numpy()
            for k, v in batch.items()}


def as_record(out: Mapping):
    """A train-step job's result as a `train.parity.StepRecord` (no state;
    a field the job did not return empty), for `step_errors`."""
    from ..train.parity import StepRecord
    return StepRecord(out["metrics"], out.get("arrays", {}),
                      out.get("grads", {}), out.get("g_updated", {}),
                      out.get("d_clipped", []), out.get("d_stats", {}),
                      None)


_BULK = ("arrays", "grads", "g_updated", "d_clipped", "d_stats",
         "d_params")


def _digest(out: Mapping) -> str:
    """SHA-256 of a record's tensors, names and bytes in a fixed order."""
    h = hashlib.sha256()
    for field in _BULK:
        for name, t in sorted(_named(out.get(field, {}), field)):
            h.update(name.encode())
            h.update(t.contiguous().view(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _named(tree, prefix: str):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, Mapping):
        return [x for k, v in tree.items() for x in _named(v, f"{prefix}/{k}")]
    return [x for i, v in enumerate(tree) for x in _named(v, f"{prefix}/{i}")]


def _record(rec) -> Dict:
    return {"metrics": rec.metrics, "arrays": rec.arrays, "grads": rec.grads,
            "g_updated": rec.g_updated, "d_clipped": rec.d_clipped,
            "d_stats": rec.d_stats,
            "d_params": {k: v.detach().cpu()
                         for k, v in rec.state.d_opt.params.items()}}


@contextlib.contextmanager
def _tf32(on: bool):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = on
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    versions of its other ops (the ROI crop's gather backward accumulates
    with atomics otherwise), so that one step gives the same gradients
    twice on the card; restored after."""
    c = torch.backends.cudnn
    saved = (c.deterministic, c.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    c.deterministic, c.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        c.deterministic, c.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_steps(app, state, batch, n: int, *noise) -> List[float]:
    """ms of each of n more train steps of `state` on the device `batch`
    (a tuple of them: Stage II), each ended by a synchronize."""
    if isinstance(batch, tuple) and len(batch) == 1:
        batch = batch[0]
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        app.train_step(state, batch, *noise)
        _sync(app.device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _job_batchnorm(inp, device):
    from ..models.layers import BatchNorm
    bn = BatchNorm(inp["weight"].numel()).to(device)
    with torch.no_grad():
        bn.weight.copy_(inp["weight"])
        bn.bias.copy_(inp["bias"])
    out: Dict = {"y": [], "dx": [], "dweight": [], "dbias": [],
                 "running_mean": [], "running_var": []}
    for x, ct in zip(inp["x"], inp["ct"]):
        x = dist.local_rows(x).to(device).requires_grad_(True)
        with dist.global_batch_stats():
            y = bn(x, train=True, update_stats=True)
        dx, dw, db = torch.autograd.grad(
            (y * dist.local_rows(ct).to(device)).sum(),
            (x, bn.weight, bn.bias))
        for k, v in (("y", y), ("dx", dx), ("dweight", dw), ("dbias", db),
                     ("running_mean", bn.running_mean),
                     ("running_var", bn.running_var)):
            out[k].append(v.detach().cpu().clone())
    return out


@contextlib.contextmanager
def _patched(module, attrs: Mapping):
    """`module`'s `attrs` replaced inside the block, restored after."""
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def _job_stage1(inp, device):
    from ..apps.common import batch_to_device
    from ..apps.stage1_app import Stage1App
    from ..config import Config
    from ..train.parity import recorded_train_step, to_float64
    cfg = Config(**inp["cfg"])
    app = Stage1App(cfg, device, state=inp["params"],
                    fg_bg=inp.get("fg_bg", True))
    local: List[List[torch.Tensor]] = []
    patched = {}
    if inp.get("local_grads"):  # what each optimizer gets before averaging
        average = dist.average_gradients
        patched["average_gradients"] = lambda g: (
            local.append([t.detach().cpu().clone() for t in g]),
            average(g))[1]
    if inp.get("local_bn"):  # the fault to show: each rank's own statistics
        patched["batch_stats_are_global"] = lambda: False
    if inp.get("float64"):
        to_float64(app, stem=inp.get("stem64", False),
                   outputs=inp.get("outputs64", False))
    batch = local_batch(inp["batch"])
    with _patched(dist, patched):  # this job's only, not the next one's
        rec = recorded_train_step(app, batch,
                                  g_updated=inp.get("g_updated"))
        ms = _timed_steps(app, rec.state, batch_to_device(batch, device),
                          inp.get("timed_steps", 0))
    out = {**_record(rec), "ms": ms}
    if local:
        names = [*rec.state.g_opt.params, *rec.state.d_opt.params]
        out["local_grads"] = dict(zip(names, local[0] + local[1]))
    return out


def _stage2_class(name):
    from ..apps import stage2_app, stage2_app_single, stage2_pose
    return {"Stage2AppApp": stage2_app.Stage2AppApp,
            "Stage2AppSingleApp": stage2_app_single.Stage2AppSingleApp,
            "Stage2PoseApp": stage2_pose.Stage2PoseApp}[name]


@contextlib.contextmanager
def _stage2_past_the_guard(app):
    """The WGAN step body (critic forwards, backward passes, updates) past
    its float32 guard; the mappers and the frozen encoder stay guarded."""
    from ..apps.stage2_app import WganSamplerApp
    app.wgan_step = functools.partial(WganSamplerApp.wgan_step.__wrapped__,
                                      app)
    try:
        yield
    finally:
        del app.wgan_step


def _job_stage2(inp, device):
    from ..apps.common import batch_to_device
    from ..config import Config
    from ..train.parity import recorded_train_step
    cfg = Config(**inp["cfg"])
    app = _stage2_class(inp["cls"])(cfg, device, inp.get("frozen"))
    for name, net in {**app.mappers, **app.critics}.items():
        net.load_state_dict(inp["params"][name], strict=True)
    batches = tuple(local_batch(b) for b in inp["batches"])
    noise = dist.local_rows(inp["noise"], dim=1)
    control = bool(inp.get("control"))
    batch = batches if len(batches) > 1 else batches[0]
    with _tf32(control), (_stage2_past_the_guard(app) if control
                          else contextlib.nullcontext()):
        rec = recorded_train_step(app, batch, noise=noise,
                                  g_updated=inp.get("g_updated"),
                                  d_clipped=inp.get("d_clipped"))
        ms = _timed_steps(app, rec.state, tuple(
            batch_to_device(b, device) for b in batches), inp.get(
                "timed_steps", 0), noise.to(device))
    return {**_record(rec), "ms": ms}


def _job_pose_ae(inp, device):
    from ..apps.common import batch_to_device
    from ..apps.stage1_pose import Stage1PoseApp
    from ..config import Config
    app = Stage1PoseApp(Config(**inp["cfg"]), device, inp["params"])
    state = app.init_state()
    grads: Dict[str, torch.Tensor] = {}
    apply = state.g_opt.apply

    def recording(g):
        grads.update({n: t.detach().cpu().clone()
                      for n, t in zip(state.g_opt.params, g)})
        apply(g)

    state.g_opt.apply = recording
    metrics = app.train_step(state, batch_to_device(
        local_batch(inp["batch"]), device))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads,
            "params": {k: v.detach().cpu()
                       for k, v in state.g_opt.params.items()}}


def _tensors_of(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors_of(v)]
    return []


def _job_int8_transfer(inp, device):
    from ..apps.common import batch_to_device
    from ..apps.testers import ConditionalTransferTester
    from ..config import Config
    tester = ConditionalTransferTester(Config(**inp["cfg"]),
                                       params=inp["params"])
    with torch.inference_mode():  # the tables are inference tensors
        tester._inference_params(batch_to_device(inp["batch"], device))
        dist.replicate(_tensors_of(tester.quant_enc)
                       + _tensors_of(tester.quant_gen))
    batch = batch_to_device(local_batch(inp["batch"]), device)
    t0 = time.perf_counter()
    images, _, score = tester.transfer_step(batch)
    _sync(device)
    return {"images": images.cpu(), "score": score.cpu(),
            "ms": [(time.perf_counter() - t0) * 1e3]}


def _job_collectives(inp, device):
    """Whether the group's backend takes device tensors for the
    collectives `dist` calls on them (all-reduce, broadcast, all-gather):
    each one called directly on `device` tensors (no staging), its result
    checked -> {name: 'ok' | 'wrong result' | the error's first line}."""
    import torch.distributed as tdist
    r, w = dist.rank(), dist.world()
    x = torch.full((4,), float(r + 1), device=device)
    total = float(sum(range(1, w + 1)))

    def all_reduce():
        y = x.clone()
        tdist.all_reduce(y)
        return bool((y == total).all())

    def broadcast():
        y = x.clone()
        tdist.broadcast(y, 0)
        return bool((y == 1).all())

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(w)]
        tdist.all_gather(parts, x)
        return all(bool((p == i + 1).all()) for i, p in enumerate(parts))

    def all_reduce_then_use():
        """A large buffer, used on the current stream right after: the
        copy back must be ordered before the use."""
        y = torch.full((1 << 25,), float(r + 1), device=device)
        tdist.all_reduce(y)
        y.div_(w)
        return bool((y == total / w).all())

    def timed_all_reduce():
        """ms of each of 3 all-reduces of `timed_numel` float32 values
        (after one untimed), host clock around a synchronized call."""
        y = torch.ones(inp["timed_numel"], device=device)
        tdist.all_reduce(y)
        ms = []
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            tdist.all_reduce(y)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    out = {}
    for fn in (all_reduce, broadcast, all_gather, all_reduce_then_use):
        try:
            out[fn.__name__] = "ok" if fn() else "wrong result"
        except Exception as e:  # noqa: BLE001 (the report is the point)
            out[fn.__name__] = f"{type(e).__name__}: " + str(e).split(
                "\n")[0][:160]
    timed = timed_all_reduce() if inp.get("timed_numel") else []
    return {"collectives": out, "backend": tdist.get_backend(),
            "all_reduce_ms": timed}


JOBS = {"batchnorm": _job_batchnorm, "stage1": _job_stage1,
        "stage2": _job_stage2, "pose_ae": _job_pose_ae,
        "int8_transfer": _job_int8_transfer,
        "collectives": _job_collectives}


def _rank_main(rank: int, n: int, port: int, d: str, platform: str,
               backend: str) -> None:
    from ..apps.common import select_device
    from ..kernels import pose_raster, s8_conv
    torch.set_num_threads(1)
    dist.init_distributed(f"127.0.0.1:{port}", n, rank, platform=platform,
                          backend=backend or None)
    try:
        device = select_device(platform)
        results = []
        for job, inp in torch.load(os.path.join(d, "inputs.pt"),
                                   weights_only=False):
            inp["cfg"] = {**inp.get("cfg", {}), "platform": platform}
            pose_raster.launches = s8_conv.launches = 0
            s8_conv.launches_by_route = {k: 0 for k in
                                         s8_conv.launches_by_route}
            out = JOBS[job](inp, device)
            if inp.get("returns") is not None:
                out = {k: v for k, v in out.items() if k in inp["returns"]}
            if inp.get("lean"):
                out["digest"] = _digest(out)
                if rank:
                    out = {k: v for k, v in out.items() if k not in _BULK}
            out["pose_launches"] = pose_raster.launches
            out["s8_launches"] = dict(s8_conv.launches_by_route)
            results.append(out)
        torch.save(results, os.path.join(d, f"rank{rank}.pt"))
    finally:
        dist.shutdown()


if __name__ == "__main__":
    a = sys.argv[1:]
    _rank_main(int(a[0]), int(a[1]), int(a[2]), a[3], a[4], a[5])
