"""Driver entry points of the port: the GRU polisher's forward, and a
multi-rank dry run.

The counterpart of the repository's root ``__graft_entry__.py``, which is
the JAX package's.

* :func:`entry` returns the polisher's forward and its inputs.
* :func:`dryrun_multichip` runs one train step of the polisher at full
  width that is data-parallel and tensor-parallel at once over ``n`` gloo
  ranks (:func:`_mesh_shape`: ``n = 8`` is data 2 x model 4), and holds its
  loss, its gradients and Adam on them against the single-device step
  (``models/polisher.make_train_step``).  Then it runs the distributed
  clustering (parallel/dist.py) over ``n`` ranks, and over two OS
  processes started as a launcher starts them, each against the merge tree.

The ``n`` ranks are threads of this process, each with its own gloo
process group on CPU tensors (``parallel/dist.GlooWorld``): a machine with
one GPU cannot give each rank a card, and NCCL cannot put two ranks on one
GPU.  The clustering runs on the configured stats backend, so under the
default (cuda) every rank's alignments launch ``csrc/stats_kernel.cu`` on
``cuda:0``.

Tensor parallelism splits the hidden dimension as the JAX package's
``param_shardings`` does: ``embed``, ``wx``, ``wh`` and ``b`` by columns
(each gate's columns, so a rank computes its own hidden units of every
gate), ``out_w`` by rows, ``out_b`` replicated.  ``nn.GRU``'s fused op
cannot be split, so the step runs the JAX cell (gate order z, r, n; a bias
on the input side only) on each rank's hidden slice: every time step
all-gathers ``h`` over the model ranks and computes the rank's slice of the
gates, and the partial logits are summed over the model ranks.  The
gradients are summed over the data ranks, and each rank runs Adam on its
own shard.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .device import polisher_device, stats_backend_default
from .models import polisher
from .models.polisher import N_CLASSES, N_FEATURES

#: Tolerances of the parallel step against the single-device step (both
#: float32 on the CPU; the parallel one sums in another order): the loss
#: relative, every gradient absolute, and Adam's weights after one step on
#: the same gradients absolute.
LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-6
ADAM_ATOL = 1e-7
#: The dry run's learning rate and batch: 2 sequences per data rank, 64
#: positions, as the JAX package's dry run.
LR = 1e-3
PER_DATA_RANK = 2
LENGTH = 64


def entry(device: Optional[torch.device] = None):
    """The polisher's forward and its inputs: ``fn(model, x)`` with the
    model of ``polisher.init_params(0)`` and a zero (2, 64, N_FEATURES)
    float32 input, on ``device`` (default: the polisher's device,
    ``cuda:0`` under the default backend)."""
    if device is None:
        device = polisher_device(stats_backend_default())
    model = polisher.model_from_state(polisher.init_params(0), device).eval()
    x = torch.zeros((2, LENGTH, N_FEATURES), dtype=torch.float32,
                    device=device)

    def fn(model, x):
        return model(x)

    return fn, (model, x)


def _mesh_shape(n: int) -> Tuple[int, int]:
    """Factor n ranks into (data, model) with the largest model axis <= 4."""
    for model in (4, 2, 1):
        if n % model == 0 and n >= model:
            return n // model, model
    return n, 1


# ---------------------------------------------------------------------------
# the data- and tensor-parallel train step
# ---------------------------------------------------------------------------

class _GatherCols(torch.autograd.Function):
    """All-gather of the model ranks' slices along the last axis.  Each
    rank's gathered copy feeds a different computation (its own gates), so
    a slice's gradient is the sum over the ranks of the gradient of the
    whole, cut to the rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(group.size())]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        width = grad.shape[-1] // ctx.group.size()
        at = ctx.group.rank() * width
        return grad[..., at: at + width], None


class _SumOverRanks(torch.autograd.Function):
    """Sum of the model ranks' partial results.  Every model rank then
    computes the same loss from the same sum, so the gradient of a rank's
    partial term is the gradient of the sum, unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _gate_cols(w: np.ndarray, t: int, tp: int) -> np.ndarray:
    """Model rank t's columns of each gate block along the last axis."""
    gates = np.split(w, 3, axis=-1)
    s = gates[0].shape[-1] // tp
    return np.concatenate([g[..., t * s: (t + 1) * s] for g in gates], axis=-1)


def _shard(flat: Dict[str, np.ndarray], t: int, tp: int
           ) -> Dict[str, np.ndarray]:
    """Model rank t's shard of JAX-layout parameters (params_to_jax)."""
    H = flat["embed"].shape[1]
    s = H // tp
    rows = slice(t * s, (t + 1) * s)
    out = {"embed": flat["embed"][:, rows]}
    for d in ("fwd", "bwd"):
        for w in ("wx", "wh", "b"):
            out[f"{d}/{w}"] = _gate_cols(flat[f"{d}/{w}"], t, tp)
    out["out_w"] = np.concatenate([flat["out_w"][:H][rows],
                                   flat["out_w"][H:][rows]])
    out["out_b"] = flat["out_b"]
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _unshard(shards: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`_shard` over the model ranks' shards, in rank
    order."""
    def gates(key):
        parts = [np.split(sh[key], 3, axis=-1) for sh in shards]
        return np.concatenate([np.concatenate([p[g] for p in parts], axis=-1)
                               for g in range(3)], axis=-1)

    s = shards[0]["embed"].shape[1]
    out = {"embed": np.concatenate([sh["embed"] for sh in shards], axis=1)}
    for d in ("fwd", "bwd"):
        for w in ("wx", "wh", "b"):
            out[f"{d}/{w}"] = gates(f"{d}/{w}")
    out["out_w"] = np.concatenate([sh["out_w"][:s] for sh in shards]
                                  + [sh["out_w"][s:] for sh in shards])
    out["out_b"] = shards[0]["out_b"]
    return out


def _tp_loss(p: Dict[str, torch.Tensor], group, feats, labels, mask,
             mask_total) -> torch.Tensor:
    """This rank's term of the loss: the masked cross-entropy sum of its
    data shard over the whole batch's mask total, from the JAX cell run on
    its hidden slice ``p``."""
    s = p["embed"].shape[1]
    x = _GatherCols.apply(feats @ p["embed"], group)          # (b, L, H)
    xs = x.transpose(0, 1)                                    # (L, b, H)
    L, b = xs.shape[:2]
    gx = {d: xs @ p[f"{d}/wx"] + p[f"{d}/b"] for d in ("fwd", "bwd")}
    h = {d: xs.new_zeros(b, s) for d in ("fwd", "bwd")}
    hs: Dict[str, list] = {"fwd": [], "bwd": []}
    for i in range(L):
        full = _GatherCols.apply(torch.stack([h["fwd"], h["bwd"]]), group)
        for k, d, pos in ((0, "fwd", i), (1, "bwd", L - 1 - i)):
            g, gh = gx[d][pos], full[k] @ p[f"{d}/wh"]
            z = torch.sigmoid(g[:, :s] + gh[:, :s])
            r = torch.sigmoid(g[:, s: 2 * s] + gh[:, s: 2 * s])
            n = torch.tanh(g[:, 2 * s:] + r * gh[:, 2 * s:])
            h[d] = (1.0 - z) * n + z * h[d]
            hs[d].append(h[d])
    h_fwd, h_bwd = torch.stack(hs["fwd"]), torch.stack(hs["bwd"][::-1])
    partial = h_fwd @ p["out_w"][:s] + h_bwd @ p["out_w"][s:]
    logits = (_SumOverRanks.apply(partial, group) + p["out_b"]).transpose(0, 1)
    ce = F.cross_entropy(logits.reshape(-1, N_CLASSES),
                         labels.reshape(-1).long(), reduction="none")
    return (ce * mask.reshape(-1)).sum() / mask_total


def _tp_rank_step(world, rank: int, dp: int, tp: int,
                  flat: Dict[str, np.ndarray], batch, lr: float):
    """One rank's step: (loss, gradient shard, shard after Adam)."""
    d, t = divmod(rank, tp)
    model_group = world.group(rank, [d * tp + i for i in range(tp)],
                              f"model{d}")
    data_group = world.group(rank, [j * tp + t for j in range(dp)],
                             f"data{t}")
    p = {k: torch.tensor(v, requires_grad=True)
         for k, v in _shard(flat, t, tp).items()}
    rows = slice(d * PER_DATA_RANK, (d + 1) * PER_DATA_RANK)
    feats, labels, mask = (torch.from_numpy(a[rows]) for a in batch)
    total = mask.sum().reshape(1)
    dist.all_reduce(total, group=data_group)
    loss = _tp_loss(p, model_group, feats, labels, mask,
                    torch.clamp(total, min=1.0)[0])
    loss.backward()
    loss = loss.detach().reshape(1)
    dist.all_reduce(loss, group=data_group)
    for v in p.values():
        dist.all_reduce(v.grad, group=data_group)
    grads = {k: v.grad.numpy().copy() for k, v in p.items()}
    torch.optim.Adam(list(p.values()), lr=lr).step()
    return float(loss[0]), grads, {k: v.detach().numpy() for k, v in p.items()}


def _batch(dp: int, seed: int = 0):
    """Seeded non-zero features, labels and a mask with zeros."""
    rng = np.random.default_rng(seed)
    B = dp * PER_DATA_RANK
    feats = rng.standard_normal((B, LENGTH, N_FEATURES)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, size=(B, LENGTH)).astype(np.int32)
    mask = (rng.random((B, LENGTH)) < 0.9).astype(np.float32)
    return feats, labels, mask


def _to_state(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX-layout arrays (weights or gradients) in the GRUPolisher layout,
    without the hidden-side biases the JAX cell does not have."""
    state = polisher.params_from_jax(flat)
    return {k: v for k, v in state.items() if k not in polisher.HIDDEN_BIASES}


def train_step_check(n: int, seed: int = 0, lr: float = LR) -> dict:
    """The data- and tensor-parallel step over ``n`` gloo rank threads
    against the single-device step on the same weights
    (``polisher.init_params(seed)``) and batch: the loss, every gradient
    gathered from the shards, and one Adam step on the same gradients.
    Raises AssertionError outside the tolerances; returns the gaps, the
    parallel step's loss, its gradients in the JAX layout, and the walls."""
    from .parallel.dist import GlooWorld

    dp, tp = _mesh_shape(n)
    state = polisher.init_params(seed)
    flat = polisher.params_to_jax(state)
    batch = _batch(dp, seed)

    t0 = time.perf_counter()
    world = GlooWorld(n)
    results = world.run(
        lambda rank: _tp_rank_step(world, rank, dp, tp, flat, batch, lr))
    step_s = time.perf_counter() - t0
    for d in range(1, dp):   # the data ranks hold one result
        for t in range(tp):
            a, b = results[t], results[d * tp + t]
            if a[0] != b[0] or any(not np.array_equal(a[1][k], b[1][k])
                                   for k in a[1]):
                raise AssertionError(f"data ranks 0 and {d} disagree")
    loss = results[0][0]
    grads = _unshard([results[t][1] for t in range(tp)])
    after = _to_state(_unshard([results[t][2] for t in range(tp)]))

    t0 = time.perf_counter()
    model = polisher.model_from_state(state, torch.device("cpu"))
    step = polisher.make_train_step(model, lr)
    want_loss = float(step(*(torch.from_numpy(a) for a in batch)))
    single_s = time.perf_counter() - t0
    want = {k: p.grad for k, p in model.named_parameters()
            if p.grad is not None}
    got = _to_state(grads)
    if sorted(got) != sorted(want):
        raise AssertionError(f"gradients {sorted(got)} vs {sorted(want)}")
    grad_gap = max(float((got[k] - want[k]).abs().max()) for k in want)

    # Adam on the parallel step's gradients, unsharded, against the shards'
    model = polisher.model_from_state(state, torch.device("cpu"))
    step = polisher.make_train_step(model, lr)
    for k, p in model.named_parameters():
        if p.requires_grad:
            p.grad = got[k].clone()
    step.optimizer.step()
    new = dict(model.named_parameters())
    adam_gap = max(float((after[k] - new[k].detach()).abs().max())
                   for k in after)

    loss_gap = abs(loss - want_loss) / abs(want_loss)
    report = dict(mesh=[dp, tp], hidden=int(flat["embed"].shape[1]),
                  batch=list(batch[0].shape), loss=loss, loss_single=want_loss,
                  loss_rel_gap=loss_gap, grad_max_abs_gap=grad_gap,
                  adam_max_abs_gap=adam_gap, step_s=step_s,
                  single_step_s=single_s, grads=grads)
    if not (loss_gap <= LOSS_RTOL and grad_gap <= GRAD_ATOL
            and adam_gap <= ADAM_ATOL):
        raise AssertionError(
            f"parallel step vs single device: loss relative gap {loss_gap} "
            f"(limit {LOSS_RTOL}), gradient gap {grad_gap} (limit "
            f"{GRAD_ATOL}), Adam gap {adam_gap} (limit {ADAM_ATOL})")
    return report


# ---------------------------------------------------------------------------
# distributed clustering
# ---------------------------------------------------------------------------

def toy_read_array(seed: int = 0, n_templates: int = 3, reads_per: int = 12):
    """The JAX package's dry-run pool: 3 templates of 300 bp, 12 reads each
    with 6% deletions, score-sorted."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    read_array = []
    rid = 0
    for _ in range(n_templates):
        template = acgt[rng.integers(0, 4, size=300)]
        for _ in range(reads_per):
            keep = rng.random(template.size) > 0.06
            seq = template[keep].tobytes().decode()
            qual = "I" * len(seq)
            read_array.append((rid, 0, f"r{rid}_x", seq, qual,
                               float(len(seq) - rid * 1e-3)))
            rid += 1
    read_array.sort(key=lambda r: -r[5])
    return [(i, 0, r[2], r[3], r[4], r[5]) for i, r in enumerate(read_array)]


def cluster(read_array, nr_cores: int, comm=None):
    """The merge tree at ``nr_cores`` (comm None) or the distributed
    clustering over ``comm``: (clusters, surviving rep ids)."""
    from .cluster.engine import GapPassTable
    from .cluster.store import build_store
    from .config import Config
    from .parallel.dist import distributed_clustering
    from .parallel.merge import merge_tree_clustering
    from .utils.ptable import load_p_table, p_table_as_matrix

    cfg = Config(nr_cores=nr_cores, outfolder=None)
    store = build_store(read_array, cfg.k, cfg.w)
    p_matrix = p_table_as_matrix(load_p_table(cfg.k, cfg.w))
    max_gap = max((c.size for c in store.min_codes), default=1)
    gap_table = GapPassTable(p_matrix, cfg.min_prob_no_hits, max_gap)
    if comm is not None:
        return distributed_clustering(store, read_array, gap_table, cfg,
                                      comm, write_intermediate=False)
    with tempfile.TemporaryDirectory() as out:
        cfg.outfolder = out
        return merge_tree_clustering(store, read_array, gap_table, cfg)


def clustering_check(n: int) -> dict:
    """The distributed clustering over ``n`` GlooWorld rank threads, each
    on its own store: every rank's result must equal the merge tree at
    ``nr_cores = n``.  Returns the walls, the exchanges, and the stats
    kernel's launches and its plain version's pairs in the ranks' run."""
    from .ops import align_stats
    from .parallel import dist as pdist

    read_array = toy_read_array()
    want = cluster(read_array, n)
    world = pdist.GlooWorld(n)
    before = (pdist.TRAFFIC["exchanges"], align_stats.LAUNCHES,
              align_stats.PLAIN_PAIRS)
    t0 = time.perf_counter()
    got = world.run(lambda rank: cluster(read_array, n, world.comm(rank)))
    wall = time.perf_counter() - t0
    for rank, res in enumerate(got):
        if res != want:
            raise AssertionError(f"rank {rank} of {n}: distributed "
                                 f"clustering diverged from the merge tree")
    return dict(ranks=n, reads=len(read_array), clusters=len(want[0]),
                wall_s=wall,
                exchanges=pdist.TRAFFIC["exchanges"] - before[0],
                stats_launches=align_stats.LAUNCHES - before[1],
                stats_plain_pairs=align_stats.PLAIN_PAIRS - before[2])


def multiprocess_check(n_ranks: int = 2, timeout_s: float = 300.0) -> dict:
    """The real multi-process transport: ``n_ranks`` OS processes of this
    module, started as a launcher starts them (parallel/dist.spawn_local),
    each joining a gloo group from RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT and running the distributed clustering over TorchComm;
    every rank's result must equal the merge tree."""
    from .parallel.dist import spawn_local

    want = cluster(toy_read_array(), n_ranks)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(n_ranks)]
        t0 = time.perf_counter()
        spawn_local([[sys.executable, "-m", "ngspeciesid_tpu_torch.graft_entry",
                      out] for out in outs], timeout_s=timeout_s, cwd=tmp)
        wall = time.perf_counter() - t0
        for rank, out in enumerate(outs):
            with open(out) as f:
                got = json.load(f)
            res = ({int(k): v for k, v in got["clusters"].items()},
                   got["alive"])
            if res != want:
                raise AssertionError(f"process rank {rank} of {n_ranks}: "
                                     f"clustering diverged from the merge "
                                     f"tree")
    return dict(ranks=n_ranks, wall_s=wall)


def dryrun_multichip(n: int) -> dict:
    """The parallel train step (:func:`train_step_check`), the distributed
    clustering over ``n`` rank threads (:func:`clustering_check`) and over
    two processes (:func:`multiprocess_check`); raises on any divergence.
    Returns each part's report."""
    return dict(train=train_step_check(n), clustering=clustering_check(n),
                processes=multiprocess_check())


def _rank_main(out_path: str) -> int:
    """A rank of :func:`multiprocess_check`: cluster the toy pool over the
    launcher's world and write the result as JSON."""
    from .parallel.dist import launcher_comm

    with launcher_comm() as comm:
        clusters, alive = cluster(toy_read_array(), comm.size, comm)
    with open(out_path, "w") as f:
        json.dump({"clusters": {str(k): v for k, v in clusters.items()},
                   "alive": alive}, f)
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1]))
