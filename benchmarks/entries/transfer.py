"""Pose transfer through the program's tester:
`ConditionalTransferTester.transfer_step` (models 12 and 1001), closed
loop, one client, one batch in flight. Each batch of a ring of distinct
seeded host batches is copied in by `batch_to_device`, transferred, and
its images copied out to host memory, as `run()` does before its PNG
writes (which this cell leaves out). A batch's latency runs from the
hand-over of its host batch to its images on the host.

Set-up makes the weights on the device, builds the tester and runs the
traffic file's `warmup_batches`. The check compares the batches of a
sample drawn from the seed (`check_batches` indices below `check_span`,
and the window's last batch) with the reference on the same inputs. The
traced run adds CUDA events around `transfer_step`, synchronized host
spans of the two copies, a profiled stretch of `profile_batches` batches
and the reference's FLOP count."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from dpig_tpu_torch.apps.common import batch_to_device
from dpig_tpu_torch.apps.testers import ConditionalTransferTester
from dpig_tpu_torch.config import Config

from .. import check, measure, weights
from ..harness import Device, Outcome, Seeds, SetupClock, model_dir, \
    remove
from ..reference import flops, stage1
from ..traffic import synthetic

NUMBERS = check.TRANSFER_NUMBERS   # what `check` computes for this entry


def host_ring(cell, seeds: Seeds):
    n, t = cell.config["nets"], cell.traffic
    return synthetic.ring(seeds.data, t["ring"], t["batch_size"],
                          n["img_H"], n["img_W"], n["keypoints"],
                          n["part_num"])


def sample(cell, seeds: Seeds) -> set:
    t = cell.traffic
    rng = np.random.default_rng(seeds.sample)
    return set(int(i) for i in rng.choice(t["check_span"], t["check_batches"],
                                          replace=False))


class Client:
    """The closed loop's client: hands the tester one host batch at a time,
    timing each."""

    def __init__(self, tester, ring: List, dev: Device, timed: bool):
        self.tester, self.ring, self.dev, self.timed = tester, ring, dev, timed
        self.served = 0                       # ring position
        self.latency_ms: List[float] = []
        self.copy_ms: List[float] = []
        self._events = []

    def batch(self):
        """One batch -> (its ring slot, images on the host, the target pose
        maps and D scores on the device)."""
        slot = self.served % len(self.ring)
        self.served += 1
        t_in = time.perf_counter()
        jb = batch_to_device(self.ring[slot], self.dev.torch)
        if self.timed:
            self.dev.sync()
            t_copied = time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        images, pose, score = self.tester.transfer_step(jb)
        if self.timed:
            e1.record()
            self.dev.sync()
            t_done = time.perf_counter()
        host = images.cpu().numpy()
        t_out = time.perf_counter()
        self.latency_ms.append((t_out - t_in) * 1e3)
        if self.timed:
            self._events.append((e0, e1))
            self.copy_ms.append(((t_copied - t_in) + (t_out - t_done)) * 1e3)
        return slot, host, pose, score

    def events_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in self._events]


def program_config(cell, platform: str, workdir: str) -> Config:
    t = cell.traffic
    return Config(**cell.config["config"], batch_size=t["batch_size"],
                  model=t["model"], is_train=False, platform=platform,
                  model_dir=workdir)


def build(cell, seeds: Seeds, dev: Device, workdir: str):
    w = weights.draw(cell.config, seeds.weights, dev.torch)
    return ConditionalTransferTester(
        program_config(cell, "" if dev.cuda else "cpu", workdir), params=w)


def reference_pairs(cell, seeds: Seeds, dev: Device, kept: Dict,
                    dtype: torch.dtype = check.REFERENCE_DTYPE,
                    tf32: bool = False):
    """[(program's (images, pose, score), reference's)] on the CPU, for
    each kept batch: the reference, in `dtype` (float32 with `tf32`: the
    control), on the ring slot that batch served."""
    ring = host_ring(cell, seeds)
    w = weights.cast(weights.draw(cell.config, seeds.weights, dev.torch),
                     dtype)
    pairs = []
    with stage1.precision(tf32):
        for _, (slot, host, pose, score) in sorted(kept.items()):
            ri, rp, rs = stage1.transfer(
                cell.config, w, stage1.to_device(ring[slot % len(ring)],
                                                 dev.torch, dtype))
            pairs.append(((torch.from_numpy(host), pose, score),
                          (ri.cpu(), rp.cpu(), rs.cpu())))
    return pairs


def program_outputs(cell, seeds: Seeds, dev: Device) -> Dict[int, tuple]:
    """After the warm-up, one pass over the ring: {i: (slot, images, pose
    maps, scores)} on the CPU (for the limits' readings)."""
    workdir = model_dir()
    try:
        tester = build(cell, seeds, dev, workdir)
        client = Client(tester, host_ring(cell, seeds), dev, timed=False)
        for _ in range(cell.traffic["warmup_batches"]):
            client.batch()
        kept = {}
        for i in range(cell.traffic["ring"]):
            slot, host, pose, score = client.batch()
            kept[i] = (slot, host, pose.cpu(), score.cpu())
        del tester, client
        dev.free()
    finally:
        remove(workdir)
    return kept


def serve(cell, seeds: Seeds, dev: Device, seconds: float, trace: bool,
          t0: float):
    """Set-up and the window -> (the kept batches by window index, the
    window's batches, e2e, ctx, peak bytes, the reduced trace)."""
    t = cell.traffic
    workdir = model_dir()
    clock = SetupClock(dev)
    try:
        ring = host_ring(cell, seeds)
        clock.lap("traffic")
        tester = build(cell, seeds, dev, workdir)
        clock.lap("weights+build")
        client = Client(tester, ring, dev, timed=False)
        for _ in range(t["warmup_batches"]):
            client.batch()
        clock.lap("warmup")
        keep = sample(cell, seeds)
        kept: Dict[int, tuple] = {}
        client.timed = trace
        client.latency_ms.clear()
        dev.sync()
        start = time.perf_counter()
        setup_s = start - t0
        clock.report(t0)
        n = 0
        while True:
            out = client.batch()
            if n in keep:
                kept[n] = out
            n += 1
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
        kept[n - 1] = out
        lat = list(client.latency_ms)
        ctx: Dict = {"config": cell.config, "traffic": t}
        summary = None
        if trace:
            ctx.update(batch_device_ms=client.events_ms(),
                       copy_ms=client.copy_ms, batches=n, window_s=window_s,
                       dtype=cell.config["precision"]["dtype"])
            client.timed = False
            summary = measure.profile(
                lambda: [client.batch() for _ in range(t["profile_batches"])],
                dev.sync)
            ctx["trace"] = summary
        peak = dev.peak_bytes()
        e2e = {"gen_img_per_s": measure.rate(t["batch_size"] * n, window_s),
               "gen_batch_p90_ms": measure.percentile(lat, 90),
               "setup_s": setup_s}
        kept = {i: (slot, host, pose.cpu(), score.cpu())
                for i, (slot, host, pose, score) in kept.items()}
        del tester, client, out
        dev.free()
    finally:
        remove(workdir)
    return kept, n, e2e, ctx, peak, summary


def run(cell, seeds: Seeds, seconds: float, trace: bool, dev: Device,
        t0: float) -> Outcome:
    kept, n, e2e, ctx, peak, summary = serve(cell, seeds, dev, seconds,
                                             trace, t0)
    numbers = check.transfer_numbers(reference_pairs(cell, seeds, dev, kept))
    if trace:
        ctx["batch_flops"] = flops.transfer_flops(cell.config,
                                                  cell.traffic["batch_size"])
    return Outcome(e2e, ctx, numbers, attempted=n, failed=0,
                   memory_peak_bytes=peak, trace=summary)
