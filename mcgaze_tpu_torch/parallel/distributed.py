"""Multi-process utilities over torch.distributed, counterpart of
mcgaze_tpu/parallel/distributed.py (the reference's torch.distributed
machinery):

  * init_distributed        <- init_dist / torch.distributed.launch: the
                               process group from the environment, NCCL
                               on the card and gloo on the CPU
  * sync_random_seed        <- rank 0's seed broadcast
  * shard_across_processes  <- the rank-strided eval sampler
  * gather_objects          <- collect_results_cpu: a two-phase pickled
                               allgather (sizes, then payloads padded to
                               the largest), in input order
  * global_normalizer       <- reduce_mean(num_pos): a loss normaliser
                               summed over the data axis
  * assert_same_structure   <- the DDP loss-key consistency check

Every function is a no-op in a single-process run (no process group), so
the same CLIs run on one device and on several processes.

The 'data' axis: every process unless parallel/mesh.py::make_mesh set a
'model' axis of M > 1, whose M processes (ranks d*M .. d*M + M - 1) hold
one batch and the shards of one model. data_index, data_count and
data_group then name this process's place on the data axis; the loss
normalisers and the logs reduce over it alone.
"""
from __future__ import annotations

import datetime
import hashlib
import os
import pickle
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _active() else 1


def process_index() -> int:
    return dist.get_rank() if _active() else 0


# the model axis of the mesh in force (set_model_axis); a data group of
# None: the default group holds the data axis
_axes = dict(n_model=1, data_group=None)


def set_model_axis(n_model: int = 1, data_group=None) -> None:
    """Record the mesh's model axis: its size and this process's group
    along the data axis (the processes that hold the same shards).
    Called by parallel/mesh.py::make_mesh; n_model=1 clears it."""
    _axes.update(n_model=n_model, data_group=data_group)


def model_count() -> int:
    """Processes on the model axis (1 without one)."""
    return _axes['n_model'] if _active() else 1


def data_count() -> int:
    """Processes on the data axis: each loads its own share of a batch."""
    return process_count() // model_count()


def data_index() -> int:
    """This process's place on the data axis (its batch share)."""
    return process_index() // model_count()


def data_group():
    """The process group of the data axis (None: the default group)."""
    return _axes['data_group']


def _env(*names) -> Optional[str]:
    for n in names:
        if os.environ.get(n):
            return os.environ[n]
    return None


def init_distributed(device='cuda', coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     timeout_s: int = 1800) -> bool:
    """Join the process group described by the arguments or the
    environment; a no-op (returns False) when no launcher configured one.
    Returns True when a group is up (also one made before the call).

    The environment, torchrun's names first, then the JAX package's:
      MASTER_ADDR + MASTER_PORT, or COORDINATOR_ADDRESS /
          JAX_COORDINATOR_ADDRESS ('host:port')   -> the rendezvous
      WORLD_SIZE, NUM_PROCESSES, JAX_NUM_PROCESSES -> world size
      RANK, PROCESS_ID, JAX_PROCESS_ID             -> this process
      LOCAL_RANK                                   -> its card
    The backend is NCCL for a CUDA `device` (each process on card
    LOCAL_RANK, else rank modulo the visible cards) and gloo otherwise."""
    if _active():
        return True
    addr = coordinator_address
    if addr is None and _env('MASTER_ADDR'):
        addr = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT') or 29500}"
    addr = addr or _env('COORDINATOR_ADDRESS', 'JAX_COORDINATOR_ADDRESS')
    if addr is None:
        return False
    if num_processes is None:
        num_processes = int(_env('WORLD_SIZE', 'NUM_PROCESSES',
                                 'JAX_NUM_PROCESSES') or 1)
    if process_id is None:
        process_id = int(_env('RANK', 'PROCESS_ID', 'JAX_PROCESS_ID') or 0)
    kwargs = {}
    if torch.device(device).type == 'cuda':
        backend = 'nccl'
        local = _env('LOCAL_RANK')
        card = torch.device(
            'cuda', int(local) if local is not None
            else process_id % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(card)
        kwargs['device_id'] = card
    else:
        backend = 'gloo'
    dist.init_process_group(
        backend, init_method=f'tcp://{addr}', world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
        **kwargs)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, where one is up."""
    if _active():
        dist.destroy_process_group()
    set_model_axis()


def _comm_device() -> torch.device:
    """Where the backend's tensors live: the current card for NCCL."""
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def sync_random_seed(seed: int | None = None) -> int:
    """Every process returns process 0's seed (drawn when None)."""
    if seed is None:
        seed = int(np.random.randint(2 ** 31))
    if process_count() == 1:
        return seed
    t = torch.tensor([seed], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def barrier(name: str = '') -> None:
    """Align every process (no-op in a single-process run). `name` labels
    the call site for a reader; torch's barrier needs none."""
    if process_count() == 1:
        return
    if dist.get_backend() == 'nccl':
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shard_across_processes(items: Sequence[Any]) -> List[Any]:
    """This process's strided slice of a global work list."""
    return list(items[process_index()::process_count()])


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return out


def gather_objects(local: List[Any]) -> List[Any]:
    """Allgather picklable per-process lists into the global list, in the
    order of the items before shard_across_processes split them. Two
    phases, no size cap: the pickles' sizes first, then one allgather of
    the payloads padded to the largest."""
    if process_count() == 1:
        return list(local)
    dev = _comm_device()
    payload = torch.frombuffer(bytearray(pickle.dumps(local)),
                               dtype=torch.uint8)
    sizes = _all_gather(torch.tensor([payload.numel()], dtype=torch.int64,
                                     device=dev))
    sizes = [int(s.item()) for s in sizes]
    buf = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    buf[:payload.numel()] = payload.to(dev)
    per_proc = [pickle.loads(g[:n].cpu().numpy().tobytes())
                for g, n in zip(_all_gather(buf), sizes)]
    # item i of the global list went to process i % P as its (i // P)-th
    out = []
    iters = [iter(x) for x in per_proc]
    for i in range(sum(len(x) for x in per_proc)):
        out.append(next(iters[i % len(iters)]))
    return out


def global_normalizer(counts: torch.Tensor, floor: float = 1.0
                      ) -> torch.Tensor:
    """Loss normalisers (avg_factor) for data-parallel training: each count
    summed over the data axis, floored at `floor`, divided by the number
    of data processes. A process's loss sum divided by this, averaged over
    the data axis (DDP's gradient mean), is the global sum over the global
    count, the single-program loss of the JAX package. The processes of a
    model axis hold one batch and count it once. One data process: the
    count floored. Counts carry no gradient."""
    counts = counts.detach().to(torch.float32)
    world = data_count()
    if world == 1:
        return counts.clamp_min(floor)
    total = counts.clone()
    dist.all_reduce(total, group=data_group())
    return total.clamp_min(floor) / world


def average_over_processes(logs: dict) -> dict:
    """Scalar logs averaged over the data axis in one allreduce (each
    data process's loss is its share of the global loss,
    global_normalizer); unchanged with one data process."""
    if data_count() == 1 or not logs:
        return logs
    names = list(logs)
    stacked = torch.stack([logs[k].detach().to(torch.float32).reshape(())
                           for k in names])
    dist.all_reduce(stacked, group=data_group())
    stacked /= data_count()
    return dict(zip(names, stacked.unbind()))


def _leaves(tree, path=''):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f'{path}/{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{path}/{i}')
    else:
        yield path, tree


def tree_structure_fingerprint(tree: Any) -> str:
    """Stable hash of a nested dict/list/tuple's structure and its leaves'
    shapes and dtypes (tensors, arrays) or types."""
    parts = []
    for path, leaf in _leaves(tree):
        shape = tuple(getattr(leaf, 'shape', ()))
        dtype = getattr(leaf, 'dtype', type(leaf).__name__)
        parts.append(f'{path}:{shape}:{dtype}')
    return hashlib.sha256('|'.join(parts).encode()).hexdigest()


def assert_same_structure(tree: Any, name: str = 'tree') -> None:
    """Every process must hold an identically structured tree (a state
    dict, a batch, the loss keys)."""
    if process_count() == 1:
        return
    fp = tree_structure_fingerprint(tree)
    digest = torch.tensor(list(bytes.fromhex(fp[:16])), dtype=torch.uint8,
                          device=_comm_device())
    gathered = _all_gather(digest)
    if not all(torch.equal(g, gathered[0]) for g in gathered):
        raise AssertionError(
            f'{name} structure differs across processes '
            f'(process {process_index()} fingerprint {fp[:16]})')
