"""Logical-axis sharding rules, scenario packing and admission placement.
Counterpart of ``repro/distributed/sharding.py``, all three halves.

The mesh half: every parameter, cache leaf and key activation carries
*logical* axis names ("embed", "heads", "ff", "vocab", ...);
``build_rules`` maps them to mesh axes with the reference's
divisibility-aware fallbacks per architecture, and ``ShardCtx.spec``
gives one mesh axis (a name, a tuple of names, or None) per tensor dim,
the entries of the reference's ``PartitionSpec``. The rules read only
axis names and sizes, so they take a shape-only :class:`AbstractMesh` as
well as a ``torch.distributed.device_mesh.DeviceMesh``. Where the
reference leaves partitioning to GSPMD, the port runs local shards:
``ShardCtx.local`` slices a full tensor to this rank's shard and
``ShardCtx.group`` gives the process group of an axis, over which the
model's explicit collectives run (``distributed/collectives.py``).

The scenario half (``pack_order``, ``pack_scenarios``, ``unpack_results``,
``scenario_mesh``) and the admission half (``ADMISSION_POLICIES``,
``admission_order``, ``next_admission_shard``, ``route_admission_shard``)
are host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


def pack_order(scenarios):
    """Architecture-aware lane-packing permutation: a stable sort of the
    scenario batch by ``(n_layers, budget)``.

    Contiguous like-``L`` blocks mean a shard (or a packed sub-batch run
    as its own program) pads toward its *local* ``L_max`` instead of the
    global one, and contiguous like-budget blocks put lanes that exhaust
    their budgets together on the same shard / in the same compaction
    neighborhood — a shard of early finishers retires its device early,
    and the whole-run compaction driver drops whole waves at once.

    Returns ``order`` with ``order[j]`` = the input index of the j-th
    packed lane. A pure permutation: engines built with ``pack=True``
    invert it on their results, so packing is result-invariant.
    """
    keys = [(sc.problem.L, sc.budget) for sc in scenarios]
    return np.asarray(sorted(range(len(scenarios)), key=keys.__getitem__),
                      dtype=np.int64)


def pack_scenarios(scenarios, n_shards: int = 1):
    """Sort scenarios by ``(n_layers, budget)`` and split them into
    ``n_shards`` contiguous shards (sizes as equal as ``array_split``).

    Returns ``(shards, order)``; concatenating the shards yields the
    packed sequence and ``order`` is :func:`pack_order`'s permutation.
    Each shard's engine then pads to the shard-local ``L_max`` /
    ``budget_max`` on its own (``batch_bo.run_packed_shards``).
    """
    order = pack_order(scenarios)
    packed = [scenarios[i] for i in order]
    chunks = np.array_split(np.arange(len(packed)), max(1, n_shards))
    return [[packed[i] for i in ch] for ch in chunks], order


def unpack_results(results, order):
    """Invert a packing permutation: ``results[j]`` belongs to input
    index ``order[j]``; returns the list in input order. The single
    scatter shared by every pack consumer, so the pack_order contract
    lives in one place."""
    out = [None] * len(results)
    for j, i in enumerate(order):
        out[i] = results[j]
    return out


ADMISSION_POLICIES = ("fifo", "edf")


def admission_order(pending, now_s: float = 0.0, policy: str = "fifo"):
    """Admission-queue ordering policy for the streaming engine: given
    the pending queue as ``(arrival_index, Scenario)`` pairs, return the
    indices *into pending* in the order requests should claim freed
    lanes.

    * ``"fifo"`` — arrival order (the historical behavior);
    * ``"edf"`` — earliest-deadline-first: ascending slack
      (``deadline_s - now_s``); requests without a deadline sort last,
      ties (and the deadline-free tail) stay in arrival order, so a
      deadline-free feed under EDF is bitwise the FIFO schedule.

    A callable ``policy(pending, now_s) -> order`` plugs in custom
    scheduling (budget-aware slack, priorities) without touching the
    engine; this hook and :func:`next_admission_shard` together define
    where a request goes and when."""
    if callable(policy):
        return policy(pending, now_s)
    if policy == "fifo":
        return list(range(len(pending)))
    if policy == "edf":
        def slack(j):
            d = pending[j][1].deadline_s
            return float("inf") if d is None else d - now_s
        return sorted(range(len(pending)), key=lambda j: (slack(j), j))
    raise ValueError(f"unknown admission policy {policy!r} "
                     f"(one of {ADMISSION_POLICIES} or a callable)")


def next_admission_shard(free_lanes, rr: int = 0):
    """Admission placement for the streaming engine's per-shard lane
    pools (``repro_torch.runtime.stream``): pick the shard with the most free
    lanes, ties broken round-robin starting from ``rr``. Returns the
    shard index, or ``None`` when no shard has a free lane.

    Per-shard admission is what keeps the multi-pool/mesh streaming
    path collective-free: a request is bound to exactly one shard's
    lane pool at admission, each pool dispatches its own whole-run
    phase programs independently (the established zero-collective
    scenario-sharding argument), and results gather host-side — no
    cross-shard rebalancing of a live lane ever happens.
    """
    n = len(free_lanes)
    best, best_free = None, 0
    for j in range(n):
        i = (rr + j) % n
        if free_lanes[i] > best_free:
            best, best_free = i, free_lanes[i]
    return best


# routing score deadband: a pool's EWMA dispatch wall must exceed the
# fleet median by more than this fraction before it costs the pool any
# admission score. Healthy pools run identical-shape programs, so their
# walls sit within timing noise of each other — the deadband keeps the
# score integer-valued (== free lanes) on a healthy fleet, which makes
# placement deterministic across identical runs and reduces the router
# exactly to most-free/round-robin when every pool is healthy.
ROUTE_WALL_DEADBAND = 0.5


def route_admission_shard(features, rr: int = 0,
                          wall_deadband: float = ROUTE_WALL_DEADBAND,
                          wall_ref: Optional[float] = None):
    """Load- and health-aware admission placement — the failover
    generalization of :func:`next_admission_shard`. ``features`` is one
    dict per pool:

    * ``free`` — free lanes (0 for dead pools);
    * ``ewma_wall_s`` — EWMA per-dispatch wall clock (None until the
      pool's first flush);
    * ``stale_frac`` — heartbeat staleness as a fraction of the grace
      window (0 while the pool is reporting; grows for muted/hung
      pools);
    * ``backoff`` — True while the pool sits in its failover
      exponential-backoff window (or is dead/muted): it takes no new
      admissions.

    Score: ``free / ((1 + wall_excess) * (1 + stale_frac))`` where
    ``wall_excess`` is the pool's EWMA dispatch wall over the fleet
    median, less the deadband — free capacity discounted by how slow
    and how silent the pool is. The best score wins; ties (every
    healthy fleet: scores are then the integer free-lane counts) break
    round-robin from ``rr``, so on a healthy fleet this routes
    identically to :func:`next_admission_shard`. Returns ``None`` when
    no eligible pool has a free lane — with every pool in backoff the
    queue simply waits a round (backoff windows are capped by the
    engine's drop-pool escalation, so this cannot deadlock).

    ``wall_ref`` overrides the wall-excess reference (the caller's
    fleet-wide median); without it the median of the walls present in
    ``features`` is used."""
    n = len(features)
    if wall_ref is not None:
        med = float(wall_ref)
    else:
        walls = [f.get("ewma_wall_s") for f in features
                 if not f.get("backoff") and f.get("ewma_wall_s")]
        med = float(np.median(walls)) if walls else 0.0
    best, best_score = None, 0.0
    for j in range(n):
        i = (rr + j) % n
        f = features[i]
        free = int(f.get("free", 0))
        if free <= 0 or f.get("backoff"):
            continue
        excess = 0.0
        w = f.get("ewma_wall_s")
        if w and med > 0.0:
            excess = max(0.0, w / med - 1.0 - wall_deadband)
        stale = max(0.0, float(f.get("stale_frac") or 0.0))
        score = free / ((1.0 + excess) * (1.0 + stale))
        if score > best_score:
            best, best_score = i, score
    return best


# ---------------------------------------------------------------------------
# the mesh half
# ---------------------------------------------------------------------------

# Logical axes that appear in the model code.
#   layers   - stacked scan dimension (never sharded)
#   batch    - global batch            -> data
#   seq      - sequence (activations)  -> None (or model under SP)
#   embed    - d_model                 -> None (or data under FSDP)
#   heads    - attention query heads   -> model (if divisible)
#   kv_heads - KV heads                -> model if divisible else None
#   kv_seq   - KV-cache sequence       -> model when kv_heads not divisible
#   ff       - MLP hidden              -> model
#   vocab    - (padded) vocabulary     -> model
#   experts  - MoE experts             -> model ("expert" mode)
#   expert_ff- per-expert hidden       -> model ("tensor" mode)
#   lru      - RG-LRU channels         -> model
#   conv     - conv1d taps             -> None
#   pod      - multi-pod axis          -> pod (DP or split-serving boundary)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes with no devices, the counterpart of
    JAX's ``AbstractMesh``: enough for the rules and specs. With a
    ``coordinate`` (this rank's index along each axis) it also slices
    tensors to that rank's shards, in one process (``ShardCtx.local``);
    it has no process groups."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coordinate: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, for an :class:`AbstractMesh` or a
    ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_coordinate(mesh) -> Optional[Tuple[int, ...]]:
    """This rank's index along each mesh axis, or None (an abstract mesh
    without one, or a rank outside the device mesh)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.coordinate
    c = mesh.get_coordinate()
    return None if c is None else tuple(c)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    mesh: object
    rules: Dict[str, Optional[str]]

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)

    def spec(self, axes: Tuple[Optional[str], ...]) -> tuple:
        """One entry per dim: the mesh axis (or tuple of axes) the
        logical axis maps to, or None; the reference's ``PartitionSpec``
        entries."""
        return tuple(self.rules.get(a) if a is not None else None
                     for a in axes)

    def _mesh_axes(self, entry) -> Tuple[str, ...]:
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)

    def shards(self, entry) -> Tuple[int, int]:
        """(this rank's index, shard count) along a spec entry: the mesh
        axes it names combined row-major, (0, 1) for None."""
        axes = self._mesh_axes(entry)
        if not axes:
            return 0, 1
        sizes = self.axis_sizes
        coord = mesh_coordinate(self.mesh)
        if coord is None:
            raise ValueError("this mesh has no coordinate for the rank")
        names = list(self.axis_sizes)
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + coord[names.index(a)]
            n *= sizes[a]
        return idx, n

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes the batch is split over (the ``batch`` rule)."""
        return self._mesh_axes(self.rules.get("batch"))

    def size(self, axis: str) -> int:
        """The size of a mesh axis (1 if the mesh has none)."""
        return self.axis_sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index along a mesh axis (0 if the mesh has none)."""
        if axis not in self.axis_sizes:
            return 0
        return self.shards(axis)[0]

    def sharded(self, logical: str, axis: str = "model") -> bool:
        """Whether ``logical`` maps to mesh axis ``axis`` of size > 1."""
        return self.rules.get(logical) == axis and self.size(axis) > 1

    def dim_axes(self, axes) -> Tuple[Tuple[str, ...], ...]:
        """Per dim of a leaf with logical ``axes``, the mesh axes of more
        than one rank that the dim is split over."""
        return tuple(tuple(a for a in self._mesh_axes(entry)
                           if self.size(a) > 1)
                     for entry in self.spec(axes))

    def split_axes(self, axes) -> Tuple[str, ...]:
        """The mesh axes of more than one rank that a leaf with logical
        ``axes`` is split over."""
        return tuple(a for d in self.dim_axes(axes) for a in d)

    def local_shape(self, shape, axes) -> Tuple[int, ...]:
        """The shape of this rank's shard of a tensor of ``shape`` with
        logical ``axes``; raises where a dim does not divide."""
        out = []
        for dim, entry in zip(shape, self.spec(axes)):
            n = 1
            for a in self._mesh_axes(entry):
                n *= self.axis_sizes[a]
            if dim % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} {axes} does "
                                 f"not divide over {entry} ({n})")
            out.append(dim // n)
        return tuple(out)

    def local(self, t, axes):
        """This rank's shard of the full tensor ``t`` (a view: each dim
        that maps to mesh axes is cut into equal contiguous parts, the
        rank taking part ``index``)."""
        for d, entry in enumerate(self.spec(axes)):
            idx, n = self.shards(entry)
            if n > 1:
                if t.shape[d] % n:
                    raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                     f"divide over {entry} ({n})")
                size = t.shape[d] // n
                t = t.narrow(d, idx * size, size)
        return t

    def group(self, axis: str):
        """The process group of mesh axis ``axis`` (``data`` or
        ``model``): None for an axis of size 1 or an abstract mesh of one
        rank along it."""
        if self.size(axis) == 1:
            return None
        if isinstance(self.mesh, AbstractMesh):
            raise ValueError(f"an AbstractMesh has no process group for "
                             f"{axis!r} (size {self.size(axis)})")
        return self.mesh.get_group(axis)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a leaf with logical ``axes`` lies on the mesh of ``ctx``: the
    counterpart of the reference's ``NamedSharding`` (the ``shardings``
    of a checkpoint's save and restore)."""
    ctx: ShardCtx
    axes: Tuple[Optional[str], ...]

    def local(self, t):
        """This rank's shard of the whole leaf ``t``, a tensor of its
        own (never a view holding the whole)."""
        part = self.ctx.local(t, self.axes)
        return part.clone() if part.shape != t.shape else part

    def gather(self, t):
        """The whole leaf from this rank's shard ``t``, on every rank."""
        from repro_torch.distributed.collectives import mesh_collective

        for d, entry in enumerate(self.ctx.spec(self.axes)):
            for a in reversed(self.ctx._mesh_axes(entry)):
                t = mesh_collective("gather", t, self.ctx, a, dim=d)
        return t


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def build_rules(cfg, mesh, *, fsdp: bool = False,
                seq_parallel: bool = False,
                dp_over_pod: bool = True) -> Dict[str, Optional[str]]:
    """Divisibility-aware logical->mesh mapping for one architecture."""
    sizes = mesh_shape(mesh)
    model = sizes.get("model", 1)
    data_axes: Tuple[str, ...] = ("data",) if "data" in sizes else ()
    if "pod" in sizes and dp_over_pod:
        data_axes = ("pod",) + data_axes  # DP spans pods by default

    rules: Dict[str, Optional[str]] = {
        "layers": None,
        "batch": data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None),
        "seq": None,
        "embed": None,       # PARAM d_model dim (FSDP shards it over data)
        "act_embed": None,   # ACTIVATION d_model dim (never FSDP-sharded)
        "conv": None,
        "vocab": "model",        # padded_vocab is a multiple of 128
        "ff": "model" if _div(cfg.d_ff, model) else None,
        "lru": "model" if _div(cfg.lru_width or cfg.d_model, model) else None,
        "blocks": None,
    }
    # attention (for attention-free archs, "heads" shards the wkv heads).
    # jit in_shardings rejects uneven sharding, so non-divisible head
    # counts replicate in the baseline; the sequence-sharded (ring)
    # attention path recovers them (§Perf).
    n_heads_eff = cfg.n_heads if cfg.n_heads else cfg.n_rwkv_heads
    if cfg.attn_sharding != "replicated" and _div(n_heads_eff, model):
        rules["heads"] = "model"
    else:
        rules["heads"] = None
    # activation-side heads: shardable either when params are, or in
    # "padded" mode (q/o padded per kv-group to a multiple of the model
    # axis at compute time — §Perf iteration B1)
    if rules["heads"] == "model" or (cfg.attn_sharding == "padded"
                                     and cfg.n_heads):
        rules["act_heads"] = "model"
    else:
        rules["act_heads"] = None
    rules["kv_heads"] = "model" if _div(cfg.n_kv_heads, model) else None
    # RG-LRU block-diagonal gates shard with the lru channels when aligned
    rules["blocks"] = "model" if _div(cfg.lru_gate_blocks, model) else None
    # decode KV-cache: shard sequence over `model` when kv heads can't be
    rules["kv_seq"] = None if rules["kv_heads"] == "model" else "model"
    # MoE
    if cfg.moe and cfg.moe_sharding == "expert" and _div(cfg.n_experts, model):
        rules["experts"] = "model"
        rules["expert_ff"] = None
    else:
        rules["experts"] = None
        rules["expert_ff"] = "model"
    if fsdp:
        rules["embed"] = data_axes[-1] if data_axes else None
    if seq_parallel:
        rules["seq"] = "model"
    return rules


def make_ctx(cfg, mesh, **kw) -> ShardCtx:
    return ShardCtx(mesh=mesh, rules=build_rules(cfg, mesh, **kw))


def local_ctx(cfg=None) -> ShardCtx:
    """Trivial one-rank ``("data", "model")`` context for tests and CPU
    smoke paths."""
    mesh = AbstractMesh((1, 1), ("data", "model"), (0, 0))
    rules = build_rules(cfg, mesh) if cfg is not None else {}
    return ShardCtx(mesh=mesh, rules=rules)


def spec_tree(template, ctx: ShardCtx):
    """Map a template tree (leaves have ``.axes``) to a tree of specs."""
    if isinstance(template, dict):
        return {k: spec_tree(v, ctx) for k, v in template.items()}
    return ctx.spec(template.axes)


def sharding_tree(template, ctx: ShardCtx):
    """Map a template tree to ``torch.distributed.tensor`` placements,
    one per mesh axis (``Shard(dim)`` where a dim of the leaf maps to
    that axis, else ``Replicate()``): what a ``DTensor`` of the leaf on
    ``ctx.mesh`` would carry, the counterpart of the reference's
    ``NamedSharding`` tree."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(ctx.axis_sizes)

    def placements(axes):
        out = [Replicate() for _ in names]
        for d, entry in enumerate(ctx.spec(axes)):
            for a in ctx._mesh_axes(entry):
                out[names.index(a)] = Shard(d)
        return tuple(out)

    if isinstance(template, dict):
        return {k: sharding_tree(v, ctx) for k, v in template.items()}
    return placements(template.axes)


def scenario_mesh(n_devices: Optional[int] = None, device_type: str = None):
    """1-D ``("scen",)`` mesh over the scenario axis for the whole-run
    engine (``core/wholerun.py``): the per-scenario programs are
    embarrassingly parallel, so the batch splits over ranks with no
    collective in the loop. With ``torch.distributed`` initialized, a
    ``DeviceMesh`` over the first ``n_devices`` ranks (default: all);
    otherwise a one-rank :class:`AbstractMesh` for this process.
    ``device_type`` defaults to ``"cuda"`` under an NCCL default group,
    else ``"cpu"``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"scenario_mesh({n_devices}) needs "
                             "torch.distributed initialized")
        return AbstractMesh((1,), ("scen",), (0,))
    from torch.distributed.device_mesh import DeviceMesh

    n = dist.get_world_size() if n_devices is None else n_devices
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=("scen",))
