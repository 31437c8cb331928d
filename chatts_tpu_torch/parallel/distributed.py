"""Multi-process initialization, request sharding, and worlds of local ranks.

Counterpart of ``chatts_tpu/parallel/distributed.py``: ``init_multihost``
wires the processes into one ``torch.distributed`` world (where JAX calls
``jax.distributed.initialize``), and request sharding follows the
reference's ``idx % world_size == rank`` convention (reference:
chatts/utils/inference_tsmllm_deepspeed.py:37-41,66-68).

The backend is always the caller's choice: ``"nccl"`` by default, for one
card a rank; ``"gloo"`` where ranks share a card (NCCL refuses two ranks on
one device) or run on the CPU.  Nothing here picks one on its own.

``run_world`` starts a world of local ranks (spawned processes, a
``file://`` store) and returns each rank's result; a rank that fails, or a
world that outlives its timeout, raises, and every rank is killed.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch.distributed as dist


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "nccl",
) -> None:
    """Initialize the default process group from the arguments or the
    environment (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID, as the
    JAX package reads them).  A coordinator address ``host:port`` becomes a
    ``tcp://`` rendezvous; one with a scheme (``tcp://``, ``file://``) is
    used as it is; with none, torch's ``env://`` variables are read."""
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])
    kwargs = {}
    if address:
        kwargs["init_method"] = address if "://" in address else f"tcp://{address}"
    else:
        kwargs["init_method"] = "env://"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, **kwargs)


def process_info() -> tuple:
    """(rank, world size); (0, 1) when no process group is initialized."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_writer() -> bool:
    """Whether this process writes what every rank holds alike (adapters,
    the optimizer's state, an export): world rank 0, or a lone process."""
    return process_info()[0] == 0


def barrier() -> None:
    """Wait for every rank of the world (nothing without one): after a
    writer's files, before any rank reads them."""
    if dist.is_initialized():
        dist.barrier()


def shard_indices(n: int, rank: Optional[int] = None,
                  world: Optional[int] = None) -> Sequence[int]:
    """The reference's sample sharding: indices with i % world == rank
    (reference: inference_tsmllm_deepspeed.py:66-68)."""
    if rank is None or world is None:
        rank, world = process_info()
    return [i for i in range(n) if i % world == rank]


def _rank_main(fn, rank: int, world: int, init_method: str, backend: str,
               timeout_s: float, args_path: str, results) -> None:
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        # Pickled here: the queue would hand tensors over as shared-memory
        # handles, which die with the rank.
        out = pickle.dumps(fn(rank, *args))
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which fails the world
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def run_world(fn: Callable[..., Any], world: int, args: Sequence[Any] = (), *,
              backend: str, timeout_s: float, store_dir: Optional[str] = None) -> List[Any]:
    """``fn(rank, *args)`` on ``world`` spawned local ranks of one process
    group (``backend``, a ``file://`` store in ``store_dir``, a temporary
    directory by default); returns the results by rank.  ``fn`` must be
    importable by the children (a module-level function).  Raises, after
    killing every rank, if a rank fails, exits without a result, or the
    world is still running after ``timeout_s`` seconds; collectives time out
    after the same time.  ``args`` go to the ranks through a file in
    ``store_dir``: a spawned child reads its start-up pipe only after
    importing, so large arguments there would start the ranks one at a
    time."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    owned = store_dir is None
    store_dir = store_dir or tempfile.mkdtemp(prefix="chatts_world_")
    os.makedirs(store_dir, exist_ok=True)
    init_method = f"file://{os.path.join(store_dir, 'store')}"
    args_path = os.path.join(store_dir, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(tuple(args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world, init_method, backend, timeout_s, args_path,
                               results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    failure = None
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue_lib.Empty:
                if time.monotonic() > deadline:
                    failure = f"the world of {world} ranks outlived its {timeout_s:.0f} s"
                    break
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode is not None]
                if dead and results.empty():
                    failure = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                               "and no result")
                    break
                continue
            if not ok:
                failure = f"rank {rank} failed:\n{value}"
                break
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        if owned:
            shutil.rmtree(store_dir, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(failure)
    return [out[rank] for rank in range(world)]
