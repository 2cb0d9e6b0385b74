"""The processes of a mesh: one controller, ``n_data * n_model - 1`` workers.

uce_tpu shards only inside its pipelines' compiled generate call, so the
port keeps a single controller: rank 0 is the calling process, which runs
the CLI, the encoders, the scheduler plan, the server and the file writes.
``start(mesh)`` spawns the other ranks (``torch.multiprocessing``, start
method ``spawn``; the kernel libraries are built first, so no worker
compiles), and every rank joins one process group (NCCL or gloo, as
``mesh.backend_for`` rules; a file store under ``mesh.store_dir``). A worker
then serves the controller's commands, which come down a pipe of its own
(a worker waits for the next one as long as it takes: a server may idle
for hours):

  * ``send_params``: a slot of weights, one tensor at a time by
    ``broadcast`` from rank 0; each rank keeps its model shard of it (the
    peak is one whole tensor, never a whole model); ``update_params``
    replaces some values of a held slot the same way;
  * ``run``: a module-level function on every rank with its slot params,
    its data slice of the batch tensors and the model group of its data
    group as the tensor-parallel context (``model_all_reduce``); the
    results (host objects) come back up the pipes;
  * ``gather_params``: the shards back to rank 0, whole again (of some
    keys only, the slot kept);
  * ``stop``.

One mesh per process: torch.distributed's default group is process-wide,
and so are this module's session and the model group of the sharded call
under way (``model_parallel``).

Device tensors move only by ``broadcast`` and ``all_reduce`` (SUM and MAX),
which NCCL and gloo both carry for CUDA tensors; a collective starts only
once every rank has its command, so its timeout bounds real work. A
failing rank ends the group: the controller kills the workers and raises.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import datetime
import os
import shutil
import tempfile
import traceback
from typing import Callable, Iterable, Mapping

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from uce_tpu_torch.ops import kernels
from uce_tpu_torch.parallel import mesh as mesh_mod

TIMEOUT = datetime.timedelta(minutes=2)
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


# ---------------------------------------------------------------------------
# the tensor-parallel context of a sharded call
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _ModelGroup:
    group: object
    rank: int
    size: int


_tp: _ModelGroup | None = None


@contextlib.contextmanager
def model_parallel(group, rank: int, size: int):
    """Make ``group`` (this rank at ``rank`` of ``size``) the model group of
    the enclosed forward: the models' row-parallel projections reduce over
    it."""
    global _tp
    saved, _tp = _tp, (_ModelGroup(group, rank, size) if size > 1 else None)
    try:
        yield
    finally:
        _tp = saved


def tp_size() -> int:
    return 1 if _tp is None else _tp.size


def tp_rank() -> int:
    return 0 if _tp is None else _tp.rank


def tp_range(n: int) -> tuple[int, int]:
    """This rank's [start, stop) of ``n`` heads, channels or experts."""
    return mesh_mod.split_range(n, tp_rank(), tp_size())


def model_all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over the model group of the
    current sharded call; ``x`` itself outside one."""
    if _tp is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=_OPS[op], group=_tp.group)
    return x


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Session:
    mesh: mesh_mod.Mesh
    rank: int
    # the controller's pipe to each worker (a worker's: its own, alone)
    conns: list = dataclasses.field(default_factory=list)
    model_groups: list = dataclasses.field(default_factory=list)
    procs: list = dataclasses.field(default_factory=list)
    store_dir: str | None = None
    params: dict = dataclasses.field(default_factory=dict)   # workers' slots
    # the controller's record of each slot: key -> (whole value's metas, layout)
    sent: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[self.rank]

    @property
    def model_group(self):
        return self.model_groups[self.mesh.coords(self.rank)[0]]


_session: _Session | None = None


def session() -> _Session | None:
    return _session


def _join(mesh: mesh_mod.Mesh, rank: int, init: str) -> _Session:
    device = mesh.devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(mesh.backend, init_method=init, world_size=mesh.size,
                            rank=rank, timeout=TIMEOUT)
    s = _Session(mesh, rank)
    s.model_groups = [dist.new_group([d * mesh.n_model + m for m in range(mesh.n_model)])
                      for d in range(mesh.n_data)]
    return s


def _prebuild(mesh: mesh_mod.Mesh) -> None:
    """Build (or load) every kernel library in the controller, so that the
    workers find them built and no two ranks compile one."""
    if mesh.devices[0].type == "cuda":
        kernels.build_all()


def start(mesh: mesh_mod.Mesh) -> _Session:
    """Spawn the workers of ``mesh`` and join its process group as rank 0
    (a one-rank mesh runs in this process alone)."""
    global _session
    if _session is not None:
        raise RuntimeError("a mesh is already running in this process: apply_mesh(None) "
                           "on its pipeline first")
    if mesh.size == 1:
        _session = _Session(mesh, 0)
        return _session
    _prebuild(mesh)
    if mesh.devices[0].type == "cuda":
        torch.cuda.empty_cache()  # room for the ranks that share this card
    store_dir = tempfile.mkdtemp(prefix="uce_mesh_", dir=mesh.store_dir)
    init = f"file://{os.path.join(store_dir, 'store')}"
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(1, mesh.size)]
    procs = [ctx.Process(target=_worker_main, args=(rank, mesh, init, theirs), daemon=True)
             for rank, (_, theirs) in enumerate(pipes, start=1)]
    for p in procs:
        p.start()
    try:
        _session = _join(mesh, 0, init)
    except BaseException:
        _kill(procs)
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    _session.procs, _session.store_dir = procs, store_dir
    _session.conns = [ours for ours, _ in pipes]
    print(f"mesh: {mesh.n_data}x{mesh.n_model} (data x model) over "
          f"{', '.join(map(str, mesh.devices))}, backend {mesh.backend}", flush=True)
    return _session


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=30)


def _teardown(clean: bool) -> None:
    global _session
    s, _session = _session, None
    if s is None or s.mesh.size == 1:
        return
    if clean:
        for p in s.procs:
            p.join(timeout=60)
    _kill(s.procs)
    for conn in s.conns:
        conn.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    shutil.rmtree(s.store_dir, ignore_errors=True)


def stop() -> None:
    """Stop the workers and leave the process group (a no-op without a
    running mesh, and in a worker)."""
    if _session is None or _session.rank != 0:
        return
    if _session.mesh.size > 1:
        try:
            _command(("stop",))
        except Exception:
            _teardown(clean=False)
            raise
    _teardown(clean=True)


atexit.register(stop)  # a caller that exits without stopping its mesh


def _controller() -> _Session:
    if _session is None or _session.rank != 0:
        raise RuntimeError("no mesh is running in this process")
    return _session


def _command(cmd: tuple) -> None:
    for conn in _session.conns:
        conn.send(cmd)


@contextlib.contextmanager
def _guard():
    """Any failure on the controller mid-command ends the whole group: its
    workers may wait in a collective that will never come."""
    try:
        yield
    except BaseException:
        _teardown(clean=False)
        raise


def _metas(v) -> list[tuple]:
    """(name, shape, dtype) of a value's tensors (a quantized weight's two)."""
    if isinstance(v, Mapping):
        return [(k, tuple(t.shape), t.dtype) for k, t in v.items()]
    return [(None, tuple(v.shape), v.dtype)]


def _broadcast_value(v, metas, device, src: int = 0, group=None):
    """Broadcast one value's tensors from ``src`` (``v`` there; None on the
    receiving ranks, which allocate them on ``device``)."""
    out = {}
    for name, shape, dtype in metas:
        if v is None:
            t = torch.empty(shape, dtype=dtype, device=device)
        else:
            t = (v[name] if name is not None else v).contiguous()
        dist.broadcast(t, src=src, group=group)
        out[name] = t
    return out[None] if None in out else out


def broadcast_from_controller(v, metas=None):
    """One value (a tensor or a quantized weight) from rank 0 to every rank;
    ``v`` on rank 0, None elsewhere (then ``metas`` describe it)."""
    s = _session
    return _broadcast_value(v, metas if metas is not None else _metas(v), s.device)


# ---------------------------------------------------------------------------
# the controller's commands
# ---------------------------------------------------------------------------

def holds(slot: str) -> bool:
    """Whether the running mesh holds slot ``slot`` (sent, not gathered)."""
    return _session is not None and slot in _session.sent


def drain(params: Mapping):
    """(key, value) pairs of a copy of ``params``, each dropped from the copy
    as it is taken: fed to ``send_params`` while nothing else holds
    ``params``, rank 0's whole tensors are freed as their shards replace
    them."""
    params = dict(params)
    while params:
        key = next(iter(params))
        yield key, params.pop(key)


def send_params(slot: str, items: Iterable[tuple[str, object]],
                layout: Callable | None = None) -> dict:
    """Stream ``items`` ((key, value) pairs, e.g. ``params.items()`` or a
    loader's) to every rank as slot ``slot``, one value at a time; each rank
    keeps its model shard (``layout(key, value)``; None: whole). Returns
    rank 0's shard. The value passed in is dropped from rank 0 as soon as
    it is sent."""
    return _put(slot, items, layout, fresh=True)


def update_params(slot: str, items: Iterable[tuple[str, object]],
                  layout: Callable | None = None) -> dict:
    """Replace the values of ``items`` in the held slot ``slot`` on every
    rank, as ``send_params`` sends them (each rank keeps its shard of each,
    the rest of the slot stays as it was); returns rank 0's shards of
    them."""
    return _put(slot, items, layout, fresh=False)


def _put(slot, items, layout, fresh: bool) -> dict:
    s = _controller()
    mesh = s.mesh
    if not fresh and slot not in s.sent:
        raise KeyError(f"the mesh holds no slot {slot!r} to update")
    record, local = ({} if fresh else s.sent[slot]), {}
    with _guard():
        if mesh.size > 1:
            _command(("params", slot, fresh))
        for key, v in items:
            lay = layout(key, v) if layout is not None and mesh.n_model > 1 else None
            metas = _metas(v)
            if mesh.size > 1:
                _command(("put", key, metas, lay))
                broadcast_from_controller(v, metas)
            record[key] = (metas, lay)
            part = mesh_mod.shard_value(v, lay, 0)
            if part is not None:
                local[key] = part
            del v
        if mesh.size > 1:
            _command(("done",))
    s.sent[slot] = record
    return local


def gather_params(slot: str, local: Mapping, keys: Iterable[str] | None = None) -> dict:
    """The whole of slot ``slot`` on rank 0 again: the other model ranks of
    data group 0 broadcast their shards over its model group; rank 0 (which
    holds ``local``) puts them back together. The workers drop the slot;
    with ``keys``, only those values come back and every rank keeps it."""
    s = _controller()
    mesh = s.mesh
    if keys is None:
        record = s.sent.pop(slot)
    else:
        keys = list(keys)
        record = {k: s.sent[slot][k] for k in keys}
    if mesh.size == 1:
        return {k: local[k] for k in record}
    out = {}
    with _guard():
        _command(("gather", slot, keys))
        for key, (metas, lay) in record.items():
            if lay is None:
                out[key] = local[key]
                continue
            parts = []
            for m in range(mesh.n_model):
                if m == 0:
                    parts.append(local.get(key))
                elif isinstance(lay, mesh_mod.Owner) and lay.rank != m:
                    parts.append(None)
                else:
                    parts.append(_broadcast_value(None, _part_metas(metas, lay, m),
                                                  s.device, src=m, group=s.model_groups[0]))
            out[key] = mesh_mod.unshard_value(parts, lay)
    return out


def _part_metas(metas, lay, m: int) -> list[tuple]:
    """The metas of model rank ``m``'s part of a value under ``lay``."""
    if isinstance(lay, mesh_mod.Owner):
        return metas
    n = sum(e - b for b, e in lay.runs[m])
    out = []
    for name, shape, dtype in metas:
        if name == "scale" and lay.dim != 0:
            out.append((name, shape, dtype))
            continue
        shape = list(shape)
        shape[lay.dim] = n
        out.append((name, tuple(shape), dtype))
    return out


def drop_params(slot: str) -> None:
    """Forget slot ``slot`` on every worker (rank 0's own copy is its
    caller's)."""
    s = _controller()
    s.sent.pop(slot, None)
    if s.mesh.size > 1:
        with _guard():
            _command(("drop", slot))


def run(fn: Callable, static, tensors: Mapping[str, tuple], params: Mapping) -> list:
    """``fn(params, static, tensors)`` on every rank; returns each rank's
    result (host objects), in rank order.

    ``tensors``: name -> (tensor, batch) with ``batch`` None (every rank
    takes it whole) or (axis, n_branches): a batch already padded by
    ``mesh.pad_batch_branched``, of which each rank takes its data group's
    rows. ``params`` are rank 0's slots; the workers use the ones sent to
    them. ``fn`` runs under ``torch.inference_mode`` with its data group's
    model group as the tensor-parallel context."""
    s = _controller()
    mesh = s.mesh
    specs = [(name, _metas(t), batch) for name, (t, batch) in tensors.items()]
    with _guard():
        if mesh.size > 1:
            _command(("run", fn, static, specs))
            for name, (t, _) in tensors.items():
                broadcast_from_controller(t)
        out = _execute(s, fn, params, static, {n: t for n, (t, _) in tensors.items()},
                       specs)
        return _gather_results(s, out)


def _slot_values(params, spec, batch) -> dict:
    slot, keys = spec
    return {k: params[slot][k].cpu() for k in keys if k in params[slot]}


def held_values(slot: str, keys: Iterable[str], local: Mapping) -> list[dict]:
    """Each rank's own tensors of ``keys`` in slot ``slot`` (its shards on a
    model axis), on the host, in rank order; rank 0's are ``local``'s."""
    return run(_slot_values, (slot, list(keys)), {}, {slot: local})


def _gather_results(s: _Session, mine) -> list:
    """Every rank's ``mine``, in rank order, on rank 0 (up the pipes); []
    elsewhere. A worker that died ends the wait (EOFError)."""
    if s.rank != 0:
        s.conns[0].send(mine)
        return []
    return [mine] + [conn.recv() for conn in s.conns]


def _execute(s: _Session, fn, params, static, tensors, specs):
    mesh = s.mesh
    d, m = mesh.coords(s.rank)
    local = {}
    for name, _, batch in specs:
        t = tensors[name]
        if batch is not None:
            axis, n_branches = batch
            t = mesh_mod.data_shard(t, mesh.n_data, d, n_branches, axis)
        local[name] = t
    group = s.model_group if mesh.size > 1 else None
    with model_parallel(group, m, mesh.n_model), torch.inference_mode():
        return fn(params, static, local)


def data_leaders(results: list, mesh: mesh_mod.Mesh) -> list:
    """The results of model rank 0 of each data group, in data order."""
    return [results[d * mesh.n_model] for d in range(mesh.n_data)]


# ---------------------------------------------------------------------------
# kernel launch counts
# ---------------------------------------------------------------------------

def local_counts(reset: bool = False) -> dict:
    """This process's kernel launch counters (``ops.kernels.launches``);
    ``reset`` sets them to 0 after reading."""
    out = kernels.launches()
    if reset:
        kernels.reset_launches()
    return out


def worker_counts(reset: bool = False) -> dict:
    """The workers' kernel launch counters summed, by counter (every counter
    0 without a mesh); ``reset`` zeroes them."""
    s = _session
    total = dict.fromkeys(kernels.COUNTERS, 0)
    if s is None or s.mesh.size == 1:
        return total
    with _guard():
        _command(("counts", reset))
        per_rank = _gather_results(s, {})
    for counts in per_rank[1:]:
        for k, v in counts.items():
            total[k] += v
    return total


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _send_back(s: _Session, params: Mapping, record: Mapping) -> None:
    """A worker of data group 0's side of ``gather_params``: every
    broadcast of its model group, as the source for its own shards."""
    m = s.mesh.coords(s.rank)[1]
    for key, (metas, lay) in record.items():
        if lay is None:
            continue
        for src in range(1, s.mesh.n_model):
            if isinstance(lay, mesh_mod.Owner) and lay.rank != src:
                continue
            _broadcast_value(params[key] if src == m else None, _part_metas(metas, lay, src),
                             s.device, src=src, group=s.model_groups[0])


def _recv() -> tuple:
    return _session.conns[0].recv()


def _worker_main(rank: int, mesh: mesh_mod.Mesh, init: str, conn) -> None:
    global _session
    if mesh.devices[rank].type == "cpu":
        torch.set_num_threads(1)
    _session = s = _join(mesh, rank, init)
    s.conns = [conn]
    d, m = mesh.coords(rank)
    try:
        while True:
            try:
                cmd = _recv()
            except EOFError:  # the controller is gone
                break
            kind = cmd[0]
            if kind == "stop":
                break
            if kind == "params":
                slot, fresh = cmd[1], cmd[2]
                params, record = ({}, {}) if fresh else (s.params[slot], s.sent[slot])
                while (put := _recv())[0] == "put":
                    _, key, metas, lay = put
                    part = mesh_mod.shard_value(broadcast_from_controller(None, metas), lay, m)
                    if part is not None:
                        params[key] = part
                    record[key] = (metas, lay)
                s.params[slot], s.sent[slot] = params, record
            elif kind == "gather":
                slot, keys = cmd[1], cmd[2]
                if keys is None:
                    params, record = s.params.pop(slot), s.sent.pop(slot)
                else:
                    params, record = s.params[slot], {k: s.sent[slot][k] for k in keys}
                if d == 0:
                    _send_back(s, params, record)
            elif kind == "drop":
                s.params.pop(cmd[1], None)
                s.sent.pop(cmd[1], None)
            elif kind == "run":
                _, fn, static, specs = cmd
                tensors = {name: broadcast_from_controller(None, metas)
                           for name, metas, _ in specs}
                try:
                    out = _execute(s, fn, s.params, static, tensors, specs)
                except BaseException:
                    # leave at once: the controller's next collective fails
                    # instead of waiting for this rank
                    traceback.print_exc()
                    os._exit(1)
                _gather_results(s, out)
            elif kind == "counts":
                _gather_results(s, local_counts(reset=cmd[1]))
    finally:
        dist.destroy_process_group()
        _session = None
