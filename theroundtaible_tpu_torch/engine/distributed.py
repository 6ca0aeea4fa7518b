"""Process groups for multi-device serving (counterpart of
theroundtaible_tpu/engine/distributed.py).

One process per device, every process running the same host program in
lockstep: the PyTorch idiom, and the JAX package's own multi-host design
("every host ... starts the same program"). Where XLA inserts the
collectives of a sharded JAX program, the port's forward issues them
itself over `torch.distributed` (models/common.py), on the process groups
of a `Mesh` (engine/sharding.py build_mesh).

Starting the group:

    # one process per rank, the JAX package's environment names ...
    ROUNDTABLE_COORDINATOR=10.0.0.2:8476 ROUNDTABLE_NUM_PROCESSES=2 \\
    ROUNDTABLE_PROCESS_ID=0 python serve.py
    # ... or torchrun's (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    torchrun --nproc-per-node 2 serve.py

and in the program `initialize(backend="nccl", device=...)`; or, from one
parent, `launch(fn, world_size=2, backend="nccl")` spawns one rank per
card (`device="cuda"`, the default), `launch(fn, 2, "gloo",
device="cuda:0")` two ranks sharing card 0, and `launch(fn, 2, "gloo",
device="cpu")` two CPU ranks; each returns what every `fn(rank, *args)`
returned.

The backend is always the caller's choice: "nccl" for one rank per card,
"gloo" for the CPU and for several ranks on one card (NCCL refuses two
ranks on one GPU). Under gloo a collective on a CUDA tensor runs on a host
copy (`all_reduce_sum`, `all_gather_cat`): correct, not NCCL's speed.
Nothing here picks a backend on its own.

The pipeline's stages pass activations with point-to-point sends
(`send_to`, asynchronous, and `recv_into`), always over gloo, a CUDA
tensor staged through pinned host memory; the sequence-parallel ring
passes its K/V shards the same way, and Ulysses swaps sequence for heads
with `all_to_all_cat`; `p2p_counts()` gives this process's calls and
seconds.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from .device import resolve_device

# The JAX package's names (engine/distributed.py), then torchrun's.
ENV_COORDINATOR = "ROUNDTABLE_COORDINATOR"
ENV_NUM_PROCESSES = "ROUNDTABLE_NUM_PROCESSES"
ENV_PROCESS_ID = "ROUNDTABLE_PROCESS_ID"


def _group_env() -> Optional[tuple[str, int, int]]:
    """(init_method, world_size, rank) from the environment, or None when
    neither the JAX package's nor torchrun's variables are set."""
    coordinator = os.environ.get(ENV_COORDINATOR)
    if coordinator:
        return (f"tcp://{coordinator}",
                int(os.environ.get(ENV_NUM_PROCESSES, "1")),
                int(os.environ.get(ENV_PROCESS_ID, "0")))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT", "29500")
        return (f"tcp://{addr}:{port}", int(os.environ["WORLD_SIZE"]),
                int(os.environ["RANK"]))
    return None


def initialize(backend: str, device=None, init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Join the process group. The address, size and rank come from the
    arguments, else from the environment (ROUNDTABLE_COORDINATOR /
    ROUNDTABLE_NUM_PROCESSES / ROUNDTABLE_PROCESS_ID, or torchrun's RANK /
    WORLD_SIZE / MASTER_ADDR / MASTER_PORT). `device` (a CUDA device)
    becomes this process's current card. Returns False, doing nothing,
    when no group is described (a single-process run); True once the
    group is up. Idempotent."""
    if dist.is_initialized():
        return True
    if init_method is None:
        found = _group_env()
        if found is None:
            return False
        init_method, env_world, env_rank = found
        world_size = env_world if world_size is None else world_size
        rank = env_rank if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError("initialize needs world_size and rank with "
                         "init_method")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def initialize_from_env(device="cuda") -> bool:
    """Join the group the environment describes (torchrun's variables or
    the ROUNDTABLE_* ones), for a command every rank runs the same way
    (`roundtable serve` / `gateway` on a mesh): gloo on the CPU or when
    the ranks outnumber the cards (several ranks on one card), NCCL
    otherwise, and on a card this rank's card (LOCAL_RANK, else the rank,
    modulo the cards present). Returns False, doing nothing, when no group
    is described."""
    found = _group_env()
    if found is None:
        return False
    if dist.is_initialized():
        return True
    _method, world, rank = found
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % max(cards, 1))
        backend = "nccl" if world <= cards else "gloo"
    return initialize(backend, dev if dev.type == "cuda" else None)


def free_port() -> int:
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, port: int, backend: str, device,
               fn: Callable, args: tuple, results) -> None:
    """A spawned rank: join the group, run fn(rank, *args), report its
    result or its traceback to the parent, leave the group."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        initialize(backend, dev, f"tcp://localhost:{port}", world_size,
                   rank)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException as e:  # noqa: BLE001 - re-raised in the parent
        results.put((rank, False, f"{type(e).__name__}: {e}\n"
                     f"{traceback.format_exc()}"))
        raise


class RankFailed(RuntimeError):
    """A spawned rank raised or died; the message carries its traceback."""


def launch(fn: Callable, world_size: int, backend: str, device="cuda",
           args: tuple = (), timeout_s: float = 600.0) -> list[Any]:
    """Run `fn(rank, *args)` on `world_size` spawned ranks that share one
    process group on `backend`: on `device` ("cuda", the default, puts
    rank r on card r, "cuda:0" puts every rank on card 0 - gloo only;
    "cpu" runs the ranks on the CPU). Without a card a CUDA device raises
    before any rank starts. `fn` must be importable by name (a
    module-level function) and its arguments and result picklable. Returns
    the ranks' results in rank order; raises RankFailed with a rank's
    traceback when one raised, died or outlived `timeout_s`, after
    stopping the others."""
    resolve_device(device)
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, port, backend, device, fn,
                               args, results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    failure: Optional[str] = None
    try:
        deadline = time.monotonic() + timeout_s
        # Drain the queue before joining (a rank blocks on a full pipe).
        while len(got) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"ranks timed out after {timeout_s} s"
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    # A rank that died without a report (killed, or a
                    # segfault): wait a moment for its report, then fail.
                    try:
                        rank, ok, out = results.get(timeout=5.0)
                    except queue.Empty:
                        failure = (f"rank {procs.index(dead[0])} died with "
                                   f"exit code {dead[0].exitcode}")
                        break
                else:
                    continue
            if ok:
                got[rank] = out
            else:
                failure = f"rank {rank} failed:\n{out}"
        for p in procs:
            p.join(timeout=30.0 if failure is None else 5.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        results.close()
    if failure is not None:
        raise RankFailed(failure)
    return [got[r] for r in range(world_size)]


# --- collectives of the sharded forward ---


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a collective on `x` runs on a host copy: gloo with a CUDA
    tensor (several ranks on one card)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`'s ranks (a new tensor under gloo with a
    CUDA tensor, else `x` reduced in place)."""
    if _staged(x, group):
        host = x.cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    dist.all_reduce(x, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's `x` of `group`, concatenated along `dim` in rank
    order (list-form all_gather)."""
    n = dist.get_world_size(group)
    src = x.cpu() if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """`x` of global rank `src` on every rank of `group` (every rank
    passes a tensor of the same shape and dtype; the sender's is read, the
    others' are overwritten). Returns the received tensor on `x`'s
    device."""
    if _staged(x, group):
        host = x.cpu()
        dist.broadcast(host, src=src, group=group)
        return host.to(x.device)
    x = x.contiguous()
    dist.broadcast(x, src=src, group=group)
    return x


# --- point-to-point sends of the pipeline (engine/pp_serving.py) ---

# Calls and seconds of this process's sends and receives (the host's side:
# the staging copy, the gloo transfer and the wait), of the sequence-
# parallel ring's hops (engine/longcontext.py: one hop passes a K/V shard
# on, its sends and receive included) and of its all-to-alls (Ulysses),
# read by p2p_counts() and reset by reset_p2p_counts().
_P2P_ZERO = {"send_calls": 0, "send_s": 0.0, "recv_calls": 0, "recv_s": 0.0,
             "ring_hops": 0, "ring_s": 0.0, "all_to_all_calls": 0,
             "all_to_all_s": 0.0}
_P2P = dict(_P2P_ZERO)


def p2p_counts() -> dict:
    """This process's point-to-point totals: send_calls, send_s,
    recv_calls, recv_s, ring_hops, ring_s, all_to_all_calls,
    all_to_all_s."""
    return dict(_P2P)


def reset_p2p_counts() -> None:
    _P2P.update(_P2P_ZERO)


def note_ring_hop(seconds: float) -> None:
    """Count one hop of the sequence-parallel ring and its seconds."""
    _P2P["ring_hops"] += 1
    _P2P["ring_s"] += seconds


def all_to_all_cat(x: torch.Tensor, split_dim: int, concat_dim: int,
                   group) -> torch.Tensor:
    """The tiled all-to-all of the JAX package's `lax.all_to_all(x,
    split_axis, concat_axis, tiled=True)` over `group`: `x` splits into one
    equal piece per rank along `split_dim`, piece j goes to rank j, and the
    pieces received are concatenated along `concat_dim` in rank order. A
    CUDA tensor under gloo goes through host memory. The exchange is one
    send and one receive per pair of ranks (gloo has no all-to-all in
    every torch release), each wait bounded by the plan group's timeout.
    Counted in p2p_counts()."""
    t0 = time.monotonic()
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    src = x.cpu() if _staged(x, group) else x
    pieces = [p.contiguous() for p in src.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(pieces[0]) for _ in range(n)]
    outs[me] = pieces[me]
    works = []
    for j in range(n):
        if j != me:
            peer = dist.get_global_rank(group, j)
            works.append(dist.isend(pieces[j], peer, group=group))
            works.append(dist.irecv(outs[j], peer, group=group))
    for work in works:
        work.wait(_wait_bound())
    out = torch.cat(outs, dim=concat_dim).to(x.device)
    _P2P["all_to_all_calls"] += 1
    _P2P["all_to_all_s"] += time.monotonic() - t0
    return out


def _wait_bound():
    """The plan group's timeout (mesh_plan.PLAN_TIMEOUT_S), the bound of
    every point-to-point wait."""
    import datetime
    from .mesh_plan import PLAN_TIMEOUT_S
    return datetime.timedelta(seconds=PLAN_TIMEOUT_S)


class PendingSend:
    """An asynchronous send in flight: `wait()` blocks until the peer has
    taken it (within the plan group's timeout). The host copy it sends from
    stays alive until then."""

    def __init__(self, work, buf):
        self._work = work
        self._buf = buf

    def wait(self) -> None:
        if self._work is None:
            return
        t0 = time.monotonic()
        self._work.wait(_wait_bound())
        _P2P["send_s"] += time.monotonic() - t0
        self._work = self._buf = None


def send_to(x: torch.Tensor, dst: int, group) -> PendingSend:
    """Send `x` to global rank `dst` over `group` (gloo), asynchronously:
    a CUDA tensor is staged through pinned host memory first (the copy
    waits for the work queued on `x`), so the caller may go on once this
    returns. Returns the PendingSend to wait on before the next send's
    buffer is needed or the call ends."""
    t0 = time.monotonic()
    if x.is_cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
    else:
        buf = x.detach().clone(memory_format=torch.contiguous_format)
    work = dist.isend(buf, dst=dst, group=group)
    _P2P["send_calls"] += 1
    _P2P["send_s"] += time.monotonic() - t0
    return PendingSend(work, buf)


def recv_into(buf: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive a tensor of `buf`'s shape and dtype from global rank `src`
    over `group` (gloo) into `buf`, waiting at most the plan group's
    timeout; a CUDA `buf` receives through pinned host memory. Returns
    `buf`."""
    t0 = time.monotonic()
    host = (torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            if buf.is_cuda else buf)
    dist.irecv(host, src=src, group=group).wait(_wait_bound())
    if host is not buf:
        buf.copy_(host, non_blocking=False)
    _P2P["recv_calls"] += 1
    _P2P["recv_s"] += time.monotonic() - t0
    return buf
