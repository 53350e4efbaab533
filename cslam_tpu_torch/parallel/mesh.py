"""Device meshes for swarm workloads: one controller, worker ranks.

Port of cslam_tpu/parallel/mesh.py. The reference's `jax.sharding.Mesh`
lets ONE caller hand whole arrays to a sharded function and get the
replicated result back; `SwarmNode`'s solver callable relies on that to
run a factor-sharded solve from one robot's solve thread. An SPMD
program started by `torchrun` cannot serve such a call, so a mesh here
is a `torch.distributed` group of `d` ranks in which rank 0 is the
calling process and ranks 1..d-1 are worker processes that
`make_swarm_mesh` spawns. Each worker runs `_serve`: it receives a
function and its small arguments from rank 0 over a pipe, runs that
SPMD body on its shard, and takes part in the body's collectives;
tensors travel only through the collectives. Rank 0 runs the same body
in the caller and returns its (replicated) result.

Backends and devices are explicit and never chosen silently:

- "nccl" (the default for a CUDA device): rank r on cuda:r, one card
  per rank; raises when d exceeds `torch.cuda.device_count()`;
- "gloo" on the CPU (`device="cpu"`): the counterpart of the
  reference tests' virtual CPU devices;
- "gloo" with a CUDA device: every rank on that one card (NCCL refuses
  two ranks on one card). Tensors and kernels stay on the card; every
  collective is staged through host memory explicitly, so nothing
  depends on the gloo build's CUDA support.

Calls into one mesh are serialized by a lock, so a solve thread and a
search never interleave their collectives. Rendezvous is a FileStore in
a fresh temporary directory, and the group has a timeout, so a
desynchronised collective raises instead of hanging. A worker that died
makes the next call raise with its exit code; after any failed call the
mesh refuses further calls. `close()` (or leaving the `with` block)
destroys the group, joins every worker under a deadline, kills any that
outlives it and leaves no child. Each worker runs in its own session
with its output in a log file, whose tail a failure reports.

Placement mirrors `jax.device_put` onto a sharding: `place_rows` shards
a tensor's rows over the ranks once and returns a handle that later
calls reuse without sending the data again; `replicate_module`
broadcasts a module's weights once.
"""

import itertools
import multiprocessing as mp
import os
import shutil
import signal
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from typing import Any, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from cslam_tpu_torch.device import DeviceLike, resolve_device

GROUP_TIMEOUT_S = 120.0  # a stuck collective or silent rank raises
CLOSE_DEADLINE_S = 15.0    # close(): joins after this are kills
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Collectives:
    """One rank's view of the group inside an SPMD body: its rank, the
    group size, its device, the collectives, and the objects placed on
    it (`objects`, keyed by handle). A body calls the same collectives
    in the same order on every rank."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        # gloo with a CUDA device: collectives run on host copies
        self.staged = backend == "gloo" and device.type == "cuda"
        self.objects = {}

    def _wire(self, x):
        """A contiguous copy of x where the collective runs (host memory
        when staged)."""
        dev = "cpu" if self.staged else x.device
        return x.detach().to(dev, copy=True).contiguous()

    def _empty(self, shape, dtype):
        dev = "cpu" if self.staged else self.device
        return torch.empty(tuple(shape), dtype=dtype, device=dev)

    def all_reduce(self, x, op: str = "sum"):
        """The elementwise reduction of x over the ranks (a new tensor)."""
        y = self._wire(x)
        dist.all_reduce(y, op=_REDUCE_OPS[op])
        return y.to(self.device)

    def sum(self, x):
        return self.all_reduce(x, "sum")

    def max(self, x):
        return self.all_reduce(x, "max")

    def all_gather(self, x):
        """(size, *x.shape): every rank's x, in rank order."""
        y = self._wire(x)
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y)
        return torch.stack(parts).to(self.device)

    def broadcast(self, x, shape, dtype):
        """Rank 0's x on every rank (x is None on the others)."""
        y = self._wire(x) if self.rank == 0 else self._empty(shape, dtype)
        dist.broadcast(y, src=0)
        return x if self.rank == 0 else y.to(self.device)

    def scatter(self, chunks, shape, dtype):
        """Rank r gets rank 0's chunks[r]; chunks is None off rank 0."""
        out = self._empty(shape, dtype)
        wire = [self._wire(c) for c in chunks] if self.rank == 0 else None
        dist.scatter(out, wire, src=0)
        return out.to(self.device)


class _Worker(NamedTuple):
    rank: int
    proc: Any
    conn: Any
    log: str


def _serve(rank, size, store_path, backend, device, timeout_s, threads,
           conn, log_path):
    """A worker rank: run the bodies rank 0 sends until it says stop."""
    os.setsid()
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    torch.set_num_threads(threads)
    dev = resolve_device(device)  # the per-process TF32 flags
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    conn.send(("ready", os.getpid()))
    dist.init_process_group(backend, store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size,
                            timeout=timedelta(seconds=timeout_s))
    col = Collectives(rank, size, dev, backend)
    print(f"rank {rank}/{size}: {backend} on {dev}", flush=True)
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:  # rank 0 is gone
                break
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                out = fn(col, *args, **kwargs)
            except Exception:
                conn.send(("error", traceback.format_exc()))
                break  # the group is out of step: stop
            conn.send(("ok", out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _log_tail(path, n_bytes=2000):
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(f.tell() - n_bytes, 0))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def _kill(proc):
    """SIGKILL the worker's session (its own process group)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        proc.kill()


class SwarmMesh:
    """A 1-D mesh of `size` ranks with one axis name; see the module
    docstring. Made by `make_swarm_mesh`."""

    def __init__(self, devices: List[torch.device], backend: str,
                 axis_name: str):
        self.devices = devices
        self.device = devices[0]
        self.size = len(devices)
        self.backend = backend
        self.axis_name = axis_name
        self.shape = {axis_name: self.size}
        self.timeout_s = GROUP_TIMEOUT_S
        self._lock = threading.Lock()
        self._handles = itertools.count(1)
        self._workers: List[_Worker] = []
        self._broken = None
        self._closed = False
        self._tmp = tempfile.mkdtemp(prefix="cslam_mesh_")
        self.startup_s = None
        t0 = time.perf_counter()
        try:
            self._start()
        except BaseException:
            self.close()
            raise
        self.startup_s = time.perf_counter() - t0

    def _start(self):
        store = os.path.join(self._tmp, "store")
        ctx = mp.get_context("spawn")
        for rank in range(1, self.size):
            parent, child = ctx.Pipe()
            log = os.path.join(self._tmp, f"rank{rank}.log")
            proc = ctx.Process(
                target=_serve, name=f"mesh-rank{rank}", daemon=True,
                args=(rank, self.size, store, self.backend,
                      str(self.devices[rank]), self.timeout_s,
                      torch.get_num_threads(), child, log))
            proc.start()
            child.close()
            self._workers.append(_Worker(rank, proc, parent, log))
        deadline = time.monotonic() + self.timeout_s
        for w in self._workers:
            status, _ = self._receive(w, deadline)
            if status != "ready":
                raise RuntimeError(f"mesh rank {w.rank} did not start")
        dist.init_process_group(self.backend,
                                store=dist.FileStore(store, self.size),
                                rank=0, world_size=self.size,
                                timeout=timedelta(seconds=self.timeout_s))
        self._col = Collectives(0, self.size, self.device, self.backend)

    def _failure(self, w, what):
        return (f"mesh rank {w.rank} (pid {w.proc.pid}) {what}; its log "
                f"ends:\n{_log_tail(w.log)}")

    def _receive(self, w, deadline):
        """The next (status, value) from worker w; raises if it exits or
        stays silent past the deadline."""
        while not w.conn.poll(0.2):
            if not w.proc.is_alive() and not w.conn.poll(0):
                raise RuntimeError(self._failure(
                    w, f"exited with code {w.proc.exitcode}"))
            if time.monotonic() > deadline:
                raise RuntimeError(self._failure(
                    w, f"did not answer within {self.timeout_s} s"))
        try:
            return w.conn.recv()
        except EOFError:
            w.proc.join(5)
            raise RuntimeError(self._failure(
                w, f"exited with code {w.proc.exitcode}")) from None

    def run(self, fn, *args, local: Optional[dict] = None, **kwargs):
        """Run the SPMD body fn(collectives, *args, **kwargs) on every
        rank; rank 0 also gets the keyword arguments in `local` (its
        tensors, which the body sends by collectives). args and kwargs
        are pickled to the workers: keep them small. Returns (rank 0's
        value, [each worker's value])."""
        with self._lock:
            if self._closed:
                raise RuntimeError("the mesh is closed")
            if self._broken:
                raise RuntimeError(f"the mesh failed earlier: "
                                   f"{self._broken}")
            for w in self._workers:
                if not w.proc.is_alive():
                    self._broken = self._failure(
                        w, f"exited with code {w.proc.exitcode}")
                    raise RuntimeError(self._broken)
            try:
                for w in self._workers:
                    w.conn.send((fn, args, kwargs))
            except (BrokenPipeError, OSError) as e:
                self._broken = f"cannot reach a worker: {e}"
                raise RuntimeError(self._broken) from e
            error, out = None, None
            try:
                out = fn(self._col, *args, **kwargs, **(local or {}))
            except Exception as e:
                error = e
            deadline = time.monotonic() + self.timeout_s + 10.0
            outs, failures = [], []
            for w in self._workers:
                try:
                    status, value = self._receive(w, deadline)
                except RuntimeError as e:
                    failures.append(str(e))
                    continue
                if status == "ok":
                    outs.append(value)
                else:
                    failures.append(f"mesh rank {w.rank} raised:\n{value}")
            if error is not None or failures:
                self._broken = "; ".join(
                    ([f"rank 0 raised {error!r}"] if error else [])
                    + failures)
                raise RuntimeError(self._broken) from error
            return out, outs

    # ------------------------------------------------------------------
    # Placement (the counterpart of device_put onto a sharding)
    # ------------------------------------------------------------------
    def place_rows(self, x) -> "ShardedRows":
        """Shard x's rows over the ranks once: rank r keeps rows
        [r * n / d, (r + 1) * n / d) on its device. The handle's later
        uses send nothing again; `free()` drops the shards."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             f"ranks")
        handle = next(self._handles)
        x = x.to(self.device)
        self.run(_place_rows, handle, tuple(x.shape), x.dtype,
                 local={"whole": x})
        return ShardedRows(self, handle, tuple(x.shape), x.dtype)

    def replicate_module(self, module, factory, *args, **kwargs):
        """Broadcast `module`'s weights (on the mesh's device) once; each
        worker builds its copy as factory(*args, **kwargs) (a picklable
        callable, e.g. the module's class) and loads them. Returns a
        handle for `data_parallel`."""
        handle = next(self._handles)
        state = module.state_dict()
        meta = [(k, tuple(v.shape), v.dtype) for k, v in state.items()]
        self.run(_place_module, handle, meta, factory, args, kwargs,
                 local={"module": module})
        return handle

    def data_parallel(self, handle, x):
        """The module of `handle` over x's batch split evenly over the
        ranks; the outputs gathered in batch order on rank 0."""
        if x.shape[0] % self.size:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{self.size} ranks")
        x = x.to(self.device)
        out, _ = self.run(_forward_split, handle, tuple(x.shape), x.dtype,
                          local={"x": x})
        return out

    def free(self, handle):
        self.run(_free, handle)

    # ------------------------------------------------------------------
    # Kernel launch counts of every rank
    # ------------------------------------------------------------------
    def launches(self):
        """{kernel: launches summed over every rank} of the port's
        search kernel (`cosine_topk_pallas.launches` counts per
        process), and the per-rank dicts."""
        mine, theirs = self.run(_launch_counts)
        per_rank = [mine] + theirs
        total = {k: sum(r[k] for r in per_rank) for k in mine}
        return total, per_rank

    def reset_launches(self):
        self.run(_reset_launches)

    def describe(self):
        """Each rank's backend, device, card name and process id."""
        mine, theirs = self.run(_describe)
        return [mine] + theirs

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def children_alive(self) -> int:
        return sum(w.proc.is_alive() for w in self._workers)

    def close(self):
        """Destroy the group, join every worker under CLOSE_DEADLINE_S,
        kill any that outlives it. Idempotent."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            try:
                w.conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        if dist.is_initialized():
            dist.destroy_process_group()
        deadline = time.monotonic() + CLOSE_DEADLINE_S
        for w in self._workers:
            w.proc.join(max(deadline - time.monotonic(), 0.0))
        for w in self._workers:
            if w.proc.is_alive():
                _kill(w.proc)
                w.proc.join(10)
            w.conn.close()
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardedRows(NamedTuple):
    """Rows of a tensor placed on a mesh by `SwarmMesh.place_rows`."""
    mesh: SwarmMesh
    handle: int
    shape: tuple
    dtype: torch.dtype

    def free(self):
        self.mesh.free(self.handle)


# ----------------------------------------------------------------------
# SPMD bodies of the placement and bookkeeping calls
# ----------------------------------------------------------------------
def _place_rows(col: Collectives, handle, shape, dtype, whole=None):
    rows = shape[0] // col.size
    chunks = None if whole is None else list(whole.split(rows))
    shard = col.scatter(chunks, (rows,) + tuple(shape[1:]), dtype)
    norms = None
    if shard.is_cuda:  # the kernel's cached row norms, once
        norms = torch.linalg.vector_norm(shard, dim=1, dtype=torch.float32)
    col.objects[handle] = (shard, norms)


def _place_module(col: Collectives, handle, meta, factory, args, kwargs,
                  module=None):
    if module is None:
        module = factory(*args, **kwargs)
    state = module.state_dict() if col.rank == 0 else {}
    loaded = {k: col.broadcast(state.get(k), shape, dtype)
              for k, shape, dtype in meta}
    if col.rank:
        module.load_state_dict(loaded, strict=True)
        module.to(col.device)
    col.objects[handle] = module.eval()


def _forward_split(col: Collectives, handle, shape, dtype, x=None):
    n = shape[0] // col.size
    chunks = None if x is None else list(x.split(n))
    part = col.scatter(chunks, (n,) + tuple(shape[1:]), dtype)
    with torch.no_grad():
        y = col.objects[handle](part)
    out = col.all_gather(y)
    return out.reshape((-1,) + tuple(y.shape[1:])) if col.rank == 0 \
        else None


def _free(col: Collectives, handle):
    col.objects.pop(handle, None)


def _launch_counts(col: Collectives):
    from cslam_tpu_torch.ops.knn_pallas import cosine_topk_pallas
    return dict(cosine_topk_pallas.launches)


def _reset_launches(col: Collectives):
    from cslam_tpu_torch.ops.knn_pallas import cosine_topk_pallas
    for k in cosine_topk_pallas.launches:
        cosine_topk_pallas.launches[k] = 0


def _describe(col: Collectives):
    cuda = col.device.type == "cuda"
    return {"rank": col.rank, "backend": col.backend,
            "device": str(col.device), "pid": os.getpid(),
            "card": torch.cuda.get_device_name(col.device) if cuda else None,
            "current_device": torch.cuda.current_device() if cuda else None}


def make_swarm_mesh(n_devices: Optional[int] = None,
                    axis_name: str = "shard", device: DeviceLike = None,
                    backend: Optional[str] = None) -> SwarmMesh:
    """1-D mesh of n ranks (see the module docstring).

    device: rank 0's device; None means the CUDA card (raises without
      one, before anything is spawned); "cpu" runs every rank on the CPU
      over gloo.
    backend: None = "nccl" on CUDA (rank r on cuda:r), "gloo" on the CPU;
      "gloo" with a CUDA device puts every rank on that card.
    n_devices: None = every card for NCCL, else 1.

    One mesh per process at a time: torch.distributed has one default
    group.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"a CPU mesh runs on gloo, not {backend}")
        devices = [dev] * (n_devices or 1)
    else:
        backend = backend or "nccl"
        count = torch.cuda.device_count()
        if backend == "nccl":
            n = n_devices or count
            if n > count:
                raise ValueError(
                    f"an NCCL mesh of {n} ranks needs {n} cards, this "
                    f"host has {count}; backend='gloo' puts every rank on "
                    f"one card")
            if dev.index not in (None, 0):
                raise ValueError("an NCCL mesh puts rank r on cuda:r; "
                                 "rank 0 is on cuda:0")
            devices = [torch.device("cuda", r) for r in range(n)]
        elif backend == "gloo":
            devices = [torch.device("cuda", dev.index or 0)] * \
                (n_devices or 1)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        from cslam_tpu_torch import _build
        _build.load_library()  # once, here, not in every rank
    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this "
                           "process: close the other mesh first")
    return SwarmMesh(devices, backend, axis_name)
