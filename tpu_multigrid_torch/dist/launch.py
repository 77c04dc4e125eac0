"""Run one function on every rank of a grid of ranks, on one host.

:func:`run_on_mesh` starts ``my * mx`` processes with the ``spawn`` start
method, joins them in a ``torch.distributed`` process group that meets
through a ``file://`` store in a temporary directory (no TCP port is opened
for the rendezvous), calls ``fn(mesh, *args)`` on every rank and returns
the ranks' results in rank order.  It is how a multi-rank mesh is had on a
CPU host (gloo) or on one card shared by several ranks (gloo, staging
through host memory, :mod:`.mesh`); on a host with one card per rank,
``backend="nccl", device="cuda"`` puts rank r on card r.  On a multi-card
host a script can equally be started with ``torchrun`` and build its mesh
with :func:`.mesh.make_grid_mesh`.

The workers import only what unpickling ``fn`` and ``args`` needs, so
``fn`` should live in a module that imports only torch and this package.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import make_grid_mesh

# Seconds a run may take before its ranks are stopped.
TIMEOUT = 900.0


def _rank_device(device: Union[str, torch.device], rank: int) -> torch.device:
    """``"cpu"``; ``"cuda"``: card ``rank % device_count``; an indexed CUDA
    device: that card for every rank."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _worker(rank, world, init, backend, device, shape, fn, args, results):
    try:
        # One intra-op thread a rank: the ranks share the host's cores.
        torch.set_num_threads(1)
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if backend == "gloo":
            # Ranks of one host talk over the loopback interface.
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
        try:
            out = fn(make_grid_mesh(shape, device=dev), *args)
            # By value: the parent may read it after this process has gone.
            results.put((rank, True, pickle.dumps(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_on_mesh(fn: Callable, shape: Tuple[int, int], *, backend: str,
                device: Union[str, torch.device], args: Sequence = ()
                ) -> list:
    """``[fn(mesh, *args) on rank r for r in range(my * mx)]``.

    ``backend``: ``"gloo"`` or ``"nccl"``.  ``device``: ``"cpu"``,
    ``"cuda"`` (rank r on card ``r % device_count``) or an indexed card
    (every rank on it).  Each rank runs one intra-op thread.  ``fn`` and
    ``args`` must pickle, and ``fn``'s result is pickled by value (return
    CPU tensors).  A rank that raises, dies or outlasts :data:`TIMEOUT`
    seconds stops every rank and raises here."""
    my, mx = shape
    world = my * mx
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tmt-mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker,
                             args=(r, world, init, backend, device, (my, mx),
                                   fn, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + TIMEOUT
        try:
            while len(got) < world:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        codes = [procs[r].exitcode for r in dead]
                        raise RuntimeError(f"ranks {dead} died (exit codes "
                                           f"{codes})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"run_on_mesh: {world - len(got)} "
                                           f"ranks still running after "
                                           f"{TIMEOUT} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            results.close()
    return [got[r] for r in range(world)]
