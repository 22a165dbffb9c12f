"""Logical-axis sharding (MaxText-style rules table): the port of
``repro.models.sharding``.

Every parameter and annotated activation carries a tuple of logical axis
names; the rules map each name to zero or more mesh axes. Mapping is
mesh-aware: rules naming axes absent from the mesh are dropped, and a dim
is sharded only if its size divides by the product of the mapped mesh axis
sizes (else a prefix of those axes that divides, else it is replicated),
so the same model places on (data, model), (pod, data, model) and one
device without per-mesh configs.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``launch.mesh``); :func:`Rules.spec` reads only its dim names and sizes,
so any object with ``mesh_dim_names`` and a ``shape`` tuple (or, as a JAX
mesh, ``axis_names`` and a ``shape`` mapping) will do. A
:class:`PartitionSpec` is the port's own tuple of per-dim entries (None, a
mesh axis name, or a tuple of names, major to minor), and
:class:`NamedSharding` pairs it with the mesh. :func:`placements` turns a
spec into DTensor placements: a dim over two mesh axes gets ``Shard(d)``
on both, which DTensor splits major to minor in mesh order, as JAX does.

Tied LM heads: a ``tie_embeddings`` model stores the head as the
embedding, logical axes ("vocab", "embed"), where the untied head is
("embed", "vocab"). Under the default rules both map to the same physical
pair, vocab -> "model" and embed -> "data", with the dims swapped, so the
xent shard plan reads the vocab axes off dim 0 of the tied matrix (see
``repro_torch.kernels.dispatch``).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

# Default logical -> mesh-axis rules (JAX's). Weights: 2-D sharded (FSDP
# over "data" x TP over "model"). Activations: batch over (pod, data),
# model-parallel features over "model".
DEFAULT_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    # --- weight axes ---
    ("embed", ("data",)),
    ("mlp", ("model",)),
    ("heads", ("model",)),
    ("kv", ("model",)),
    ("vocab", ("model",)),
    ("experts", ("model",)),
    ("expert_mlp", ()),
    ("lora", ()),
    ("conv", ()),
    ("ssm_inner", ("model",)),
    ("ssm_state", ()),
    ("norm", ()),
    # --- activation axes ---
    ("act_batch", ("pod", "data")),
    ("act_seq", ()),
    ("act_embed", ()),
    ("act_residual", ()),
    ("act_mlp", ("model",)),
    ("act_heads", ("model",)),
    ("act_kv", ("model",)),
    ("act_vocab", ("model",)),
    ("act_experts", ("model",)),
    ("act_expert_cap", ("data",)),
    ("act_moe_group", ("pod", "data")),
    ("act_ssm_inner", ("model",)),
    ("act_ssm_heads", ("model",)),
    ("act_ssm_state", ()),
    # --- cache axes ---
    ("cache_batch", ("data",)),
    ("cache_seq", ("model",)),
    ("cache_kv", ()),
)


class PartitionSpec(tuple):
    """Per-dim mesh axes: None, an axis name, or a tuple of names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh: where each dim of one tensor lives."""
    mesh: object
    spec: PartitionSpec


def mesh_axes(mesh) -> dict:
    """{axis name: size} of ``mesh``, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


class Rules:
    def __init__(self, overrides: Sequence[Tuple[str, Tuple[str, ...]]] = ()):
        self._map = dict(DEFAULT_RULES)
        for k, v in overrides:
            self._map[k] = tuple(v) if v is not None else ()

    def spec(self, logical_axes: Sequence[Optional[str]], mesh,
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        """The PartitionSpec of ``logical_axes`` on ``mesh``.

        Divisibility-guarded: a dim whose size does not divide by the
        mapped mesh-axis product takes the longest prefix of those axes
        that divides, or is replicated.
        """
        sizes = mesh_axes(mesh)
        parts = []
        used = set()
        for i, ax in enumerate(logical_axes):
            if ax is None:
                parts.append(None)
                continue
            axes = tuple(a for a in self._map.get(ax, ())
                         if a in sizes and a not in used)
            if shape is not None:
                while axes and shape[i] % math.prod(sizes[a] for a in axes):
                    axes = axes[:-1]
            if not axes:
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        return PartitionSpec(*parts)

    def sharding(self, logical_axes, mesh, shape=None) -> NamedSharding:
        return NamedSharding(mesh, self.spec(logical_axes, mesh, shape))


def spec_mesh_axes(spec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """A spec as per-dim tuples of mesh axis names (``None`` -> ``()``,
    a name -> a 1-tuple), padded with replicated dims to ``ndim``: the
    form the dispatch plans read."""
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    out = []
    for e in entries[:ndim]:
        if e is None:
            out.append(())
        elif isinstance(e, (tuple, list)):
            out.append(tuple(e))
        else:
            out.append((e,))
    return tuple(out)


def placements(spec, mesh, ndim: int) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh dim).

    A dim over several mesh axes must list them in mesh order (major to
    minor), the only order DTensor splits a dim in; another order raises.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec_mesh_axes(spec, ndim)):
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: dim {d} over mesh axes {axes} "
                             f"is not in mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spec_of(x) -> Optional[NamedSharding]:
    """The NamedSharding of a DTensor (dims split over mesh dims in mesh
    order), or None for a plain tensor."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x):
        return None
    mesh = x.device_mesh
    per = [[] for _ in range(x.ndim)]
    for name, pl in zip(mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            per[pl.dim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"spec_of: placement {pl} has no PartitionSpec")
    return NamedSharding(mesh, PartitionSpec(
        *(None if not a else a[0] if len(a) == 1 else tuple(a)
          for a in per)))


def _is_sharded(mesh) -> bool:
    return mesh is not None and math.prod(mesh_axes(mesh).values()) > 1


def place(x: torch.Tensor, sharding: NamedSharding, copy: bool = False):
    """``x`` (the same full value on every rank) as a DTensor laid out per
    ``sharding``: each rank keeps its own shard, cut as DTensor cuts it
    (``torch.chunk`` along each sharded dim, mesh dims in order), with no
    communication and the autograd history of ``x`` kept. The shard is a
    view of ``x`` unless ``copy`` (then it owns contiguous storage: a
    parameter or a cache that is written in place; ``x`` may then be an
    expanded view, a zero cache of which each rank allocates only its
    shard)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    pls = placements(sharding.spec, mesh, x.ndim)
    local = x
    for pl, n, i in zip(pls, mesh.shape, mesh.get_coordinate()):
        if isinstance(pl, Shard):
            local = torch.chunk(local, n, pl.dim)[i]
    stride = x.stride()
    if copy:
        local = local.clone(memory_format=torch.contiguous_format)
        stride = _contiguous_strides(x.shape)
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=x.shape, stride=stride)


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for d in reversed(tuple(shape)):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


def lay_out(x, sharding: NamedSharding):
    """``x`` as a DTensor laid out per ``sharding``: a DTensor is
    redistributed (if it is not so already), a plain tensor (the same
    full value on every rank) cut into this rank's shard."""
    want = placements(sharding.spec, sharding.mesh, x.ndim)
    if not is_dtensor(x):
        return place(x, sharding)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(sharding.mesh, want)


def wrap(local: torch.Tensor, sharding: NamedSharding, shape):
    """This rank's local part of a value of global ``shape`` laid out per
    ``sharding``, as that DTensor (contiguous, as its strides say)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        local.contiguous(), sharding.mesh,
        placements(sharding.spec, sharding.mesh, local.ndim),
        run_check=False, shape=torch.Size(shape),
        stride=_contiguous_strides(shape))


def shard(x, logical_axes, rules: Rules, mesh=None):
    """Lay an activation out per its logical axes: a redistribute of a
    DTensor; a no-op on plain tensors and on a mesh of one device."""
    if not is_dtensor(x):
        return x
    mesh = mesh if mesh is not None else x.device_mesh
    if not _is_sharded(mesh):
        return x
    return lay_out(x, rules.sharding(logical_axes, mesh, x.shape))


def mesh_context(mesh):
    """Under a mesh, plain tensors that meet DTensors (positions, rope
    tables, masks: the same on every rank) count as replicated
    (:func:`replicated_plain`); a no-op without one."""
    return contextlib.nullcontext() if mesh is None else replicated_plain()


@contextlib.contextmanager
def replicated_plain():
    """Plain tensors that meet DTensors count as replicated. Nests: an
    inner context leaves the outer one on (torch's
    ``implicit_replication`` switches it off on every exit, so a plain
    version run under it inside a model's forward would switch it off for
    the rest of the forward)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        yield
        return
    with implicit_replication():
        yield


def full_value(x):
    """A DTensor's full value (a plain tensor on every rank); anything
    else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def laid_out_as(g, p):
    """``g`` (a gradient) redistributed to the layout of ``p`` (its
    parameter) where both are DTensors: autograd may hand back a partial
    sum or another split."""
    if (is_dtensor(g) and is_dtensor(p)
            and tuple(g.placements) != tuple(p.placements)):
        return g.redistribute(p.device_mesh, p.placements)
    return g


# The VLM's image embeddings (B, n_image_tokens, D) and an audio model's
# (B, n_codebooks, S) tokens and labels, as JAX lays them out
# (``repro.launch.dryrun.input_specs``)
IMAGE_AXES = ("act_batch", None, "act_embed")
CODEBOOK_AXES = ("act_batch", None, "act_seq")


def batch_axes(name: str, ndim: int) -> tuple:
    """The logical axes of the batch leaf ``name`` of ``ndim`` dims, JAX's
    input layouts: ``image_embeds`` per :data:`IMAGE_AXES`, a 3-D leaf
    (an audio model's tokens and labels) per :data:`CODEBOOK_AXES`, and
    the (B, S) leaves (``tokens``, ``labels``, ``positions``,
    ``segment_ids``, ``loss_weights``) per ("act_batch", "act_seq")."""
    if name == "image_embeds":
        return IMAGE_AXES
    if ndim == 3:
        return CODEBOOK_AXES
    return ("act_batch", "act_seq")[:ndim]


def shard_batch(batch: dict, mesh, rules: Rules) -> dict:
    """The global batch (the same plain tensors on every rank: ``tokens``,
    ``labels``, ...) as DTensors laid out per :func:`batch_axes`: each
    rank keeps its data shard."""
    out = {}
    for k, v in batch.items():
        if v is None or not torch.is_tensor(v):
            out[k] = v
            continue
        out[k] = lay_out(v, rules.sharding(batch_axes(k, v.ndim), mesh,
                                           v.shape))
    return out


def embed_lookup(w, tokens, rules: Rules, mesh):
    """``w[tokens]`` on a mesh, laid out per ("act_batch", "act_seq",
    "act_embed"): the table gathered whole on every rank (the gather
    GSPMD makes for the lookup of an FSDP table), the lookup on this
    rank's tokens. The table's gradient is each rank's partial sum over
    its tokens, summed over the axes that split the tokens on the way
    back to the table's layout. (DTensor's own rules for the lookup fail
    on a table split over two mesh axes.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    tok = rules.sharding(("act_batch", "act_seq"), mesh, tokens.shape)
    tokens = lay_out(tokens, tok)
    whole = (Replicate(),) * len(tokens.placements)
    table = w.redistribute(mesh, whole) if is_dtensor(w) else \
        DTensor.from_local(w, mesh, whole, run_check=False)
    local = table.to_local(grad_placements=tuple(
        Partial() if p.is_shard() else Replicate()
        for p in tokens.placements))
    shape = tuple(tokens.shape) + (w.shape[-1],)
    return wrap(local[tokens.to_local()],
                NamedSharding(mesh, PartitionSpec(*tok.spec, None)), shape)


# ------------------------------------------------------ eager collectives
#
# The expert-parallel MoE route (``layers.moe_local``) and the head-sharded
# Mamba2 route (``layers.mamba_local``) run on local tensors; these are
# their collectives, eager ``torch.distributed`` calls
# over the groups of named mesh axes (``mesh.get_group``), and the autograd
# functions that place them. Each takes ``axes``, a tuple of mesh axis
# names major to minor (a dim split over them as DTensor splits it); an
# axis of one rank is skipped, so on a mesh of one device every one is the
# identity. gloo has no reduce-scatter: a gradient is all-reduced and then
# cut.

def all_reduce(x, mesh, axes, op=None):
    """``x`` all-reduced in place over the mesh ``axes`` (one axis after
    another; axes of one rank skipped): JAX's psum/pmax."""
    import torch.distributed as dist
    sizes = mesh_axes(mesh)
    for a in axes:
        if sizes[a] > 1:
            dist.all_reduce(x, op=op or dist.ReduceOp.SUM,
                            group=mesh.get_group(a))
    return x


def shard_index(mesh, axes) -> int:
    """This rank's index along ``axes`` major to minor (JAX's
    ``axis_index`` folded in that order, and DTensor's split of a dim over
    mesh dims)."""
    sizes = mesh_axes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def axes_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in axes)


def _all_gather(x, mesh, axes, dim: int):
    """The shards of ``x`` along ``dim`` over ``axes``, concatenated in
    shard order (the minor axis first, so each step joins whole blocks)."""
    import torch.distributed as dist
    sizes = mesh_axes(mesh)
    for a in reversed(tuple(axes)):
        if sizes[a] > 1:
            parts = [torch.empty_like(x) for _ in range(sizes[a])]
            dist.all_gather(parts, x.contiguous(), group=mesh.get_group(a))
            x = torch.cat(parts, dim)
    return x


def _own(x, mesh, axes, dim: int):
    """This rank's shard of ``x`` along ``dim`` over ``axes`` (a
    ``torch.chunk`` piece, as DTensor cuts it)."""
    n = axes_size(mesh, axes)
    return x if n == 1 else torch.chunk(x, n, dim)[shard_index(mesh, axes)]


class _Sum(torch.autograd.Function):
    """Forward: the partial values summed over ``axes``. Backward: the
    (replicated) gradient passes to every partial as it is."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GradSum(torch.autograd.Function):
    """Forward: a replicated value passes as it is. Backward: the partial
    gradients the ranks form from it are summed over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axes), None, None


class _SharedSum(torch.autograd.Function):
    """Forward: the partial values summed over ``axes``. Backward: the
    partial gradients the ranks form of that sum (each uses it for its own
    part of the work) summed over ``axes`` too."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axes), None, None


class _Mean(torch.autograd.Function):
    """Forward: the mean over ``axes`` of each rank's value (each rank's a
    mean over an equal share of the samples). Backward: each rank's share
    of the (replicated) gradient, 1/n of it."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = axes_size(mesh, axes)
        return all_reduce(x.clone(), mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _Gather(torch.autograd.Function):
    """Forward: the shards along ``dim`` over ``axes`` gathered whole.
    Backward: the gradient summed over ``grad_axes`` (the axes over which
    the ranks formed partial gradients of the whole), then this rank's
    shard of it."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad_axes):
        ctx.args = (mesh, axes, dim, grad_axes)
        out = _all_gather(x, mesh, axes, dim)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, grad_axes = ctx.args
        if any(mesh_axes(mesh)[a] > 1 for a in grad_axes):
            g = all_reduce(g.contiguous().clone(), mesh, grad_axes)
        return _own(g, mesh, axes, dim).contiguous(), None, None, None, None


class _Scatter(torch.autograd.Function):
    """Forward: this rank's shard along ``dim`` over ``axes`` of a
    replicated value. Backward: the shards' gradients gathered whole (the
    replicated value's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _own(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _all_gather(g, mesh, axes, dim), None, None, None


def psum(x, mesh, axes):
    """Partial values summed over ``axes``; the gradient passes through."""
    return _Sum.apply(x, mesh, tuple(axes)) if axes_size(mesh, axes) > 1 \
        else x


def grad_psum(x, mesh, axes):
    """``x`` as it is; its partial gradients summed over ``axes``."""
    return _GradSum.apply(x, mesh, tuple(axes)) \
        if axes_size(mesh, axes) > 1 else x


def psum_shared(x, mesh, axes):
    """Partial values summed over ``axes``, where each rank uses the sum
    for its own part of the work: the partial gradients are summed too
    (``grad_psum(psum(x))``)."""
    return _SharedSum.apply(x, mesh, tuple(axes)) \
        if axes_size(mesh, axes) > 1 else x


def pmean(x, mesh, axes):
    """The mean over ``axes`` of the ranks' means (see ``_Mean``)."""
    return _Mean.apply(x, mesh, tuple(axes)) if axes_size(mesh, axes) > 1 \
        else x


def gather(x, mesh, axes, dim: int, grad_axes=()):
    """``x``'s shards along ``dim`` over ``axes`` gathered whole (an FSDP
    gather); its gradient summed over ``grad_axes`` and cut back (a
    reduce-scatter where ``grad_axes`` are ``axes``)."""
    if axes_size(mesh, axes) == 1 and axes_size(mesh, grad_axes) == 1:
        return x
    return _Gather.apply(x, mesh, tuple(axes), dim, tuple(grad_axes))


def scatter(x, mesh, axes, dim: int):
    """This rank's shard of the replicated ``x`` along ``dim`` over
    ``axes``; the gradient gathered whole."""
    return _Scatter.apply(x, mesh, tuple(axes), dim) \
        if axes_size(mesh, axes) > 1 else x


def tree_shardings(logical_tree, mesh, rules: Rules, shape_tree=None):
    """Map a tree of logical-axis tuples to NamedShardings (with
    ``shape_tree``, divisibility-guarded per leaf). Trees are nested
    dicts, or flat ``{path: axes}`` dicts."""
    if isinstance(logical_tree, tuple):
        shape = None if shape_tree is None else tuple(
            shape_tree.shape if hasattr(shape_tree, "shape") else shape_tree)
        return rules.sharding(logical_tree, mesh, shape)
    return {k: tree_shardings(v, mesh, rules,
                              None if shape_tree is None else shape_tree[k])
            for k, v in logical_tree.items()}
