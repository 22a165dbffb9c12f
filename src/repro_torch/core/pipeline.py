"""Staged leaf-update pipeline shared by the whole optimizer zoo: the port
of ``repro.core.pipeline``.

Every optimizer of :mod:`repro_torch.core` is a composition of stages
routed per parameter label (``core.labels``: first / last / matrix /
vector). A :class:`Stages` value describes what happens to one label
group, in fixed order:

    grad-scale fold -> [project] -> [momentum EMA (+nesterov)] ->
    [standardize] -> [normalize] -> [adam | adams] -> lr scale -> apply

and :func:`build_pipeline` turns ``{label: Stages}`` plans into a
:class:`~repro_torch.core.types.GradientTransformation` with both entry
points: ``update`` (delta mode: updates returned, applied by
``apply_updates``) and ``update_params`` (write mode, with ``grad_scale``).
On the plain path write mode replays delta mode's cast chain (round the
update to the gradient's dtype, then to the parameter's on apply), so the
two entry points are bitwise equal, as in JAX.

Kernel lowering under ``impl="fused"`` (``repro_torch.kernels.dispatch``;
the kernels on CUDA tensors, their plain versions on CPU tensors):

  ======================================  ==================================
  composition                             kernel entry points
  ======================================  ==================================
  ``norm`` in {col,row,larger}, no        ``normalize`` (delta) /
  momentum/adam/standardize               ``norm_update`` (write)
  momentum EMA + ``norm`` in              ``momentum_norm`` (delta) /
  {col,row,larger}, no nesterov/adam      ``momentum_norm_update`` (write)
  ======================================  ==================================

Everything else (adam, adams, sign/ns/svd norms, projections, nesterov
blends, standardize) stays on the plain per-leaf path. ``grad_scale`` (the
trainer's clip factor) goes into the kernels, which multiply g at read
time; plain branches form ``g * grad_scale`` with JAX's promotion (a bf16
g times an f32 tensor is f32; a Python number is cast to g's dtype first).

State is :class:`PipeState` ``(count, mu, nu, extra, host_count)`` of flat
``{path: tensor}`` dicts: ``mu`` the momentum or Adam first moment
(``momentum_dtype`` for non-vector leaves; low-rank f32 for projected
ones), ``nu`` the Adam second moment (f32); buffers a leaf does not use
are zero-length f32 placeholders, so the layout is uniform and JAX's.
``extra`` is ``None``, Stable-SPAM's ``{"norm_ema", "max_ema": {path}}``
or the projection family's ``{"proj": {path}}``. Both entry points update
the state's tensors in place (the kernels write the momentum in place, as
the TPU's aliasing does) and return a :class:`PipeState` holding them;
``update_params`` also writes the parameters in place. ``update`` is a
shape and dtype fixed point of ``init``.

No step synchronises with the host: lr, gscale, the step count and the
momentum reset stay on the device. ``host_count`` mirrors the count on the
host for the one decision that must be taken there, the projectors'
refresh. The exceptions are ``torch.linalg.svd`` on a CUDA tensor, which
checks its solver's status on the host: the ``svd`` norm kind every step
(``sgd_svdnorm``) and GaLore/Fira's refresh steps synchronise.

On a mesh the parameters, gradients and the state made by ``init`` are
DTensors laid out alike; ``update_params(shardings=...)`` (a flat
``{path: NamedSharding}``, ``models.sharding.tree_shardings``) hands each
leaf's sharding to the kernel entry points, which run on the local shards
and all-reduce the sums of squares (``kernels.dispatch``), and the plain
branches run on the DTensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.model import flatten

from .labels import LabelRules, label_tree, transposed_tree
from .normalization import (flip_kind, normalize, ns_orthogonalize,
                            resolve_larger)
from .types import GradientTransformation, Schedule

_f32 = torch.float32

_LABELS = ("first", "last", "matrix", "vector")


def _empty(p):
    return torch.zeros((0,), dtype=_f32, device=p.device)


def _zeros(p, dtype=_f32):
    # laid out as p (a DTensor's shards stay on their ranks)
    return torch.zeros_like(p, dtype=dtype,
                            memory_format=torch.contiguous_format)


def _lr_at(lr, count):
    # a Python lr stays a Python float, rounded to f32 as jnp.asarray does
    return lr(count) if callable(lr) else float(np.float32(lr))


def _times(a, s: float):
    """a * s in f32, as JAX multiplies an f32 array by a Python float."""
    if torch.is_tensor(a):
        return a * s
    return float(np.float32(a) * np.float32(s))


def jax_dtype(g: torch.Tensor, s) -> torch.dtype:
    """dtype of ``g * s`` under JAX's promotion: an f32 tensor promotes a
    bf16 g to f32 (torch would keep bf16); a Python number is weakly
    typed and keeps g's dtype."""
    return torch.promote_types(g.dtype, s.dtype) if torch.is_tensor(s) \
        else g.dtype


def jax_mul(g: torch.Tensor, s):
    """``g * s`` with JAX's promotion (see ``jax_dtype``); a Python number
    is rounded to g's dtype first, as JAX's weak typing does."""
    if torch.is_tensor(s):
        dt = jax_dtype(g, s)
        return g.to(dt) * s.to(dt)
    return g * float(torch.tensor(s, dtype=g.dtype))


def muon_lr_scale(shape) -> float:
    """Muon's matched-lr scaling (Liu et al., 2025): 0.2 * sqrt(max dims)."""
    return 0.2 * float(max(shape[-2], shape[-1])) ** 0.5


def _ema_(m: torch.Tensor, gf: torch.Tensor, beta: float,
          tmp: torch.Tensor) -> torch.Tensor:
    """m <- beta*m + (1-beta)*gf in place, with JAX's operations and
    rounding (two products and one add); ``tmp`` is a buffer of m's shape."""
    torch.mul(gf, 1.0 - beta, out=tmp)
    return m.mul_(beta).add_(tmp)


def _adam_leaf(g, m, v, count, b1, b2, eps):
    """Adam's moments and step. ``m`` and ``v`` are f32 and updated in
    place; returns the f32 update.

    The JAX package's operations in its order (``b1*m + (1-b1)*g``,
    ``b2*v + (1-b2)*g*g``, ``m/(1-b1^t) / (sqrt(v/(1-b2^t)) + eps)``), done
    in place where that keeps the rounding: at llama-1b's stacked w_gate
    (268 M elements) the out-of-place form holds six f32 temporaries of
    the leaf, about 6 GB beside the state; this holds two (three for a
    bf16 g)."""
    gf = g.to(_f32)
    tmp = torch.empty_like(m)
    _ema_(m, gf, b1, tmp)
    torch.mul(gf, 1.0 - b2, out=tmp)
    tmp.mul_(gf)
    v.mul_(b2).add_(tmp)
    del gf
    torch.div(v, 1.0 - b2 ** (count + 1), out=tmp)
    tmp.sqrt_().add_(eps)
    upd = torch.div(m, 1.0 - b1 ** (count + 1))
    return upd.div_(tmp)


# --------------------------------------------------------------------------
# Low-rank projection helpers (GaLore / Fira / APOLLO family).
# --------------------------------------------------------------------------

def _proj_left(shape) -> bool:
    """Project the smaller dimension (GaLore's rule): left iff d_in <= d_out."""
    return shape[-2] <= shape[-1]


def _rank_for(shape, rank: int) -> int:
    return min(rank, shape[-2], shape[-1])


def _svd_projector(g: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r left (or right) singular vectors of g, shape (..., min_dim, r);
    stacked leaves project per slice. A column's sign is the solver's
    choice (LAPACK builds differ). A refresh from zero moments is invariant
    to it: a flipped column of P flips the matching row of R and of Adam's
    moments and update, and ``P @ upd`` is left as it was; a later refresh
    keeps the old basis's moments, so there the signs enter the update, as
    in the JAX package."""
    u, _, vt = torch.linalg.svd(g.to(_f32), full_matrices=False)
    if _proj_left(g.shape):
        return u[..., :, :r].contiguous()            # (..., m, r)
    return vt[..., :r, :].mT.contiguous()            # (..., n, r)


def _projector_seed(seed: int, block: int, index: int) -> int:
    """A generator seed from (Project.seed, count // update_proj_gap, leaf
    index): the port's counterpart of JAX's fold_in chain."""
    return int(np.random.SeedSequence([seed, block, index])
               .generate_state(1)[0])


def _random_projector(seed: int, shape, r: int, device) -> torch.Tensor:
    """APOLLO's Gaussian projector: JAX's shape (..., d, r) and its 1/sqrt(r)
    scale, drawn from an explicit ``torch.Generator`` (``jax.random``
    cannot be drawn in torch, so the values differ from JAX's)."""
    d = shape[-2] if _proj_left(shape) else shape[-1]
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(tuple(shape[:-2]) + (d, r), generator=gen, dtype=_f32,
                    device=device)
    return x / float(np.sqrt(np.float32(r)))


def _project(g, p):
    # left: R = P^T G  (..., r, n); right: R = G P  (..., m, r)
    if _proj_left(g.shape):
        return p.mT @ g
    return g @ p


def _project_back(r_upd, p, shape):
    if _proj_left(shape):
        return p @ r_upd
    return r_upd @ p.mT


@dataclasses.dataclass(frozen=True)
class Project:
    """Low-rank projection stage config (GaLore family).

    ``mode``: "galore" (SVD projector, adam in the subspace, project back),
    "fira" (+ full-rank residual scaled by the low-rank adam norm ratio),
    "apollo" (random projector, channel-wise gradient scaling) or
    "apollo_mini" (rank-1 tensor-wise variant with the sqrt(128) boost).
    """
    mode: str
    rank: int = 256
    update_proj_gap: int = 200
    scale_factor: float = 1.0
    seed: int = 0

    @property
    def eff_rank(self) -> int:
        return 1 if self.mode == "apollo_mini" else self.rank

    @property
    def random(self) -> bool:
        return self.mode in ("apollo", "apollo_mini")


@dataclasses.dataclass(frozen=True)
class Stages:
    """Stage composition for one label group (see the module docstring).

    ``momentum``  — EMA coefficient of the first-moment stage (0 = off);
                    ``nesterov`` takes ``beta*m' + (1-beta)*g`` as the
                    direction instead of ``m'``.
    ``standardize`` — SWAN GradNorm: zero mean, unit variance per row.
    ``norm``      — normalization kind (col/row/larger/sign/ns/svd) of the
                    direction, or None; ``ns_steps`` for the Newton-Schulz
                    kind. ``flip_transposed`` flips col<->row for
                    transposed-storage (tied-head) leaves.
    ``adam``      — full Adam on this group (``weight_decay`` decoupled);
                    exclusive with momentum/norm.
    ``adams``     — AdamS: the second moment made at read time from the
                    momentum and the gradient, ``sqrt(b2*m_hat^2 +
                    (1-b2)*g^2)``, so only a first moment is kept.
    ``project``   — low-rank :class:`Project` stage (runs its own Adam on
                    the projected gradient).
    ``use_adam_lr`` / ``lr_scaling`` — lr source and Muon's per-matrix lr
                    scale.
    """
    momentum: float = 0.0
    nesterov: bool = False
    standardize: bool = False
    norm: Optional[str] = None
    ns_steps: int = 5
    flip_transposed: bool = False
    adam: bool = False
    adams: bool = False
    weight_decay: float = 0.0
    project: Optional[Project] = None
    use_adam_lr: bool = False
    lr_scaling: bool = False


ADAM_STAGE = Stages(adam=True)
ADAM_LR_STAGE = Stages(adam=True, use_adam_lr=True)


class HostCount:
    """The step count on the host, beside ``PipeState.count`` on the
    device. ``init`` and ``models.weights.load_opt_state`` set it, each
    step advances it in place (as the device count is), and the projection
    stage reads it to decide a refresh without reading the device back."""
    __slots__ = ("n",)

    def __init__(self, n: int = 0):
        self.n = int(n)


class PipeState(NamedTuple):
    count: torch.Tensor  # 0-d int32
    mu: dict             # first moment; zero-length when unused
    nu: dict             # Adam second moment; zero-length when unused
    extra: object = None  # projectors / Stable-SPAM's EMAs
    host_count: Optional[HostCount] = None


def _run_norm(d, kind, ns_steps, shape):
    if kind == "ns":
        return ns_orthogonalize(d, ns_steps)
    return normalize(d, resolve_larger(kind, shape))


def build_pipeline(
    plans: dict,
    lr: Schedule | float,
    adam_lr: Schedule | float | None = None,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    rules: Optional[LabelRules] = None,
    require_last: bool = False,
    impl: str = "jnp",
    momentum_dtype: str = "float32",
    pre: Optional[Callable] = None,
    pre_init: Optional[Callable] = None,
    reset_interval: int = 0,
) -> GradientTransformation:
    """Build a :class:`GradientTransformation` from per-label stage plans.

    ``plans`` maps every label in ``("first", "last", "matrix", "vector")``
    to a :class:`Stages`. ``impl="fused"`` lowers matching compositions to
    the kernels (see the module docstring); ``"jnp"`` is the plain per-leaf
    maths of the JAX package's jnp route. ``momentum_dtype`` sets the
    storage dtype of non-vector first-moment buffers. ``pre(grads, extra,
    count) -> (grads, extra)`` and ``pre_init(params) -> extra-dict``
    install a tree-level hook; ``reset_interval`` zeroes (mu, nu) every k
    steps (``count % k == 0 and count > 0``).
    """
    rules = rules or LabelRules()
    adam_lr = adam_lr if adam_lr is not None else lr
    missing = [l for l in _LABELS if l not in plans]
    if missing:
        raise ValueError(f"plans missing labels {missing}")
    try:
        mdt = {"float32": torch.float32,
               "bfloat16": torch.bfloat16}[momentum_dtype]
    except KeyError:
        raise ValueError(f"momentum_dtype must be float32|bfloat16, "
                         f"got {momentum_dtype!r}") from None
    if impl not in ("jnp", "fused"):
        raise ValueError(f"unknown impl {impl!r}")
    fused = impl == "fused"
    if fused:
        from repro_torch.kernels import dispatch as _kd

    projects = [st.project for st in plans.values() if st.project is not None]
    if len(set(projects)) > 1:
        raise ValueError("at most one Project spec per pipeline")
    proj_spec = projects[0] if projects else None

    def _mu_dtype(lab):
        return _f32 if lab == "vector" else mdt

    def _use_kernel(st, shape, kind) -> bool:
        return (fused and kind is not None and not st.adam
                and not st.adams and st.project is None
                and not st.standardize and not st.nesterov
                and _kd.supported(shape, kind))

    def _leaf_index(tree) -> dict:
        # the leaf's place in path order: one of the random projector's
        # seeds (JAX folds in its flatten index)
        return {k: i for i, k in enumerate(sorted(tree))}

    def init(params):
        params = flatten(params)
        labels = label_tree(params, rules, require_last=require_last)

        def mk_mu(lab, p):
            st = plans[lab]
            if st.project is not None:
                r = _rank_for(p.shape, st.project.eff_rank)
                rshape = ((r, p.shape[-1]) if _proj_left(p.shape)
                          else (p.shape[-2], r))
                return torch.zeros(tuple(p.shape[:-2]) + rshape, dtype=_f32,
                                   device=p.device)
            if st.adam or st.adams or st.momentum:
                return _zeros(p, _mu_dtype(lab))
            return _empty(p)

        def mk_nu(lab, p):
            st = plans[lab]
            if st.project is not None:
                return mk_mu(lab, p)  # low-rank, f32
            return _zeros(p) if st.adam else _empty(p)

        extra = pre_init(params) if pre_init is not None else None
        if proj_spec is not None:
            index = _leaf_index(params)

            def mk_proj(k, lab, p):
                st = plans[lab]
                if st.project is None:
                    return _empty(p)
                r = _rank_for(p.shape, st.project.eff_rank)
                if st.project.random:
                    return _random_projector(
                        _projector_seed(st.project.seed, 0, index[k]),
                        p.shape, r, p.device)
                d = p.shape[-2] if _proj_left(p.shape) else p.shape[-1]
                return torch.zeros(tuple(p.shape[:-2]) + (d, r), dtype=_f32,
                                   device=p.device)

            extra = {"proj": {k: mk_proj(k, labels[k], p)
                              for k, p in params.items()}}
        dev = next(iter(params.values())).device if params else None
        return PipeState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: mk_mu(labels[k], p) for k, p in params.items()},
            nu={k: mk_nu(labels[k], p) for k, p in params.items()},
            extra=extra, host_count=HostCount(0))

    @torch.no_grad()
    def _step(grads, state, params, write, grad_scale=None, shardings=None):
        """Shared per-leaf routing for both entry points (``write=False``:
        delta mode; ``write=True``: parameters written in place)."""
        grads = flatten(grads)
        params = flatten(params) if params is not None else {}
        count = state.count
        lr_t = _lr_at(lr, count)
        alr_t = _lr_at(adam_lr, count)
        extra = state.extra
        host = state.host_count
        if host is None:  # a state built by hand: read the count once
            host = HostCount(int(count))

        if pre is not None:
            if grad_scale is not None:
                # the hook must see the clipped gradients: the trainer's
                # clip tree-map, with JAX's promotion
                grads = {k: jax_mul(g, grad_scale) for k, g in grads.items()}
                grad_scale = None
            grads, extra = pre(grads, extra, count)

        if reset_interval:
            # on the device, no host branch: torch.where in place
            do_reset = ((count % reset_interval) == 0) & (count > 0)
            for x in (*state.mu.values(), *state.nu.values()):
                if x.numel():
                    x.masked_fill_(do_reset, 0)

        if proj_spec is not None:
            refresh = host.n % proj_spec.update_proj_gap == 0
            block = host.n // proj_spec.update_proj_gap
            index = _leaf_index(grads)

        def emit(u, dtype, p):
            # delta mode returns the update rounded to the (scaled)
            # gradient's dtype; write mode applies it
            u = u.to(dtype)
            return u if not write else p.add_(u.to(p.dtype))

        def project_leaf(k, st, gsc, m, v, p):
            pr = st.project
            gf = gsc.to(_f32)
            pj = extra["proj"][k]
            if refresh:
                # JAX forms the new projector every step and keeps it only
                # on refresh steps (lax.cond); the port forms it only there,
                # with the same result
                r = _rank_for(gsc.shape, pr.eff_rank)
                if pr.random:
                    pj.copy_(_random_projector(
                        _projector_seed(pr.seed, block, index[k]),
                        gsc.shape, r, gsc.device))
                else:
                    pj.copy_(_svd_projector(gf, r))
            R = _project(gf, pj)
            r_upd = _adam_leaf(R, m, v, count, b1, b2, eps)
            if pr.mode == "galore":
                full = _project_back(r_upd, pj, gsc.shape) * pr.scale_factor
            elif pr.mode == "fira":
                back = _project_back(r_upd, pj, gsc.shape)
                resid = gf - _project_back(R, pj, gsc.shape)
                phi = (torch.linalg.vector_norm(r_upd)
                       / (torch.linalg.vector_norm(R) + 1e-12))
                full = (back + phi * resid) * pr.scale_factor
            else:  # apollo / apollo_mini: channel-wise gradient scaling
                if pr.mode == "apollo_mini":
                    s = (torch.linalg.vector_norm(r_upd)
                         / (torch.linalg.vector_norm(R) + 1e-12))
                    # tensor-wise, with the heuristic sqrt(rank_ref) boost
                    full = gf * s * float(np.sqrt(np.float32(128.0)))
                else:
                    # channel = output column when left-projected
                    axis = -2 if _proj_left(gsc.shape) else -1
                    num = torch.linalg.vector_norm(r_upd, dim=axis,
                                                   keepdim=True)
                    den = torch.linalg.vector_norm(R, dim=axis,
                                                   keepdim=True) + 1e-12
                    full = gf * (num / den)
                full = full * pr.scale_factor
            return emit(-lr_t * full, gsc.dtype, p)

        def leaf(k, lab, tr, g, m, v, p):
            st = plans[lab]
            sh = {} if shardings is None else {"sharding": shardings[k]}
            # plain branches scale g as the trainer's clip tree-map does;
            # kernel branches pass grad_scale into the kernels, which
            # multiply g at read time, and need only the scaled dtype (JAX
            # drops the unused g * grad_scale; eagerly it is a full pass)
            gdt = g.dtype if grad_scale is None else jax_dtype(g, grad_scale)

            def gsc():
                return g if grad_scale is None else jax_mul(g, grad_scale)

            if st.project is not None:
                return project_leaf(k, st, gsc(), m, v, p)

            if st.adam or st.adams:
                # cast-on-read/write: the moments' maths in f32, the first
                # moment stored in its own dtype
                m_f = m if m.dtype == _f32 else m.to(_f32)
                if st.adam:
                    upd = _adam_leaf(gsc(), m_f, v, count, b1, b2, eps)
                else:
                    # AdamS: the second moment is made at read time from
                    # the momentum and the raw gradient, so there is no nu
                    gf = gsc().to(_f32)
                    tmp = torch.empty_like(m_f)
                    _ema_(m_f, gf, b1, tmp)
                    upd = torch.div(m_f, 1.0 - b1 ** (count + 1))  # m_hat
                    den = upd * b2
                    den.mul_(upd)
                    torch.mul(gf, 1.0 - b2, out=tmp)
                    tmp.mul_(gf)
                    den.add_(tmp).sqrt_().add_(eps)
                    del gf, tmp
                    upd.div_(den)
                    del den
                if m_f is not m:
                    m.copy_(m_f)
                    del m_f
                if st.weight_decay:
                    if p is None:
                        raise ValueError("weight_decay requires params to be "
                                         "passed to update()")
                    upd.add_(p.to(_f32) * st.weight_decay)
                lr_eff = alr_t if st.use_adam_lr else lr_t
                return emit(upd.mul_(-lr_eff), gdt, p)

            s = muon_lr_scale(g.shape) if st.lr_scaling else 1.0
            kind = st.norm
            if tr and st.flip_transposed:
                # tied head stored (V, D): the norm along the output
                # dimension is a row norm of the storage layout
                kind = flip_kind(kind)
            lr_eff = _times(alr_t if st.use_adam_lr else lr_t, s)

            if st.momentum:
                if _use_kernel(st, g.shape, kind):
                    if not write:
                        _, d = _kd.momentum_norm(m, g, st.momentum, kind,
                                                 gscale=grad_scale, **sh)
                        return emit(-lr_eff * d, gdt, p)
                    _kd.momentum_norm_update(p, m, g, st.momentum, lr_eff,
                                             kind, gscale=grad_scale, **sh)
                    return p
                gf = gsc().to(_f32)
                # cast-on-read/write: EMA and norm in f32, storage in m's
                # dtype
                d = st.momentum * m.to(_f32) + (1.0 - st.momentum) * gf
                m.copy_(d)
                if st.nesterov:
                    d = st.momentum * d + (1.0 - st.momentum) * gf
                del gf
            else:
                if _use_kernel(st, g.shape, kind):
                    if not write:
                        return emit(-lr_eff * _kd.normalize(
                            g, kind, gscale=grad_scale, out_dtype=_f32,
                            **sh), gdt, p)
                    return _kd.norm_update(p, g, lr_eff, kind,
                                           gscale=grad_scale, **sh)
                d = gsc().to(_f32)

            if st.standardize:
                # jnp.std is the population deviation: correction=0
                # (torch.std divides by n - 1 by default)
                std = torch.std(d, dim=-1, keepdim=True, correction=0)
                d = (d - d.mean(dim=-1, keepdim=True)) / (std + 1e-8)
            if kind is not None:
                d = _run_norm(d, kind, st.ns_steps, g.shape)
            return emit(-lr_eff * d, gdt, p)

        labels = label_tree(grads, rules, require_last=require_last)
        tr = (transposed_tree(grads, rules) if rules.tied_last
              else dict.fromkeys(grads, False))
        out = {k: leaf(k, labels[k], tr[k], g, state.mu[k], state.nu[k],
                       params.get(k))
               for k, g in grads.items()}
        count.add_(1)
        host.n += 1
        return out, PipeState(count, state.mu, state.nu, extra, host)

    def update(grads, state, params=None):
        return _step(grads, state, params, write=False)

    def update_params(grads, state, params, shardings=None, grad_scale=None):
        """Write theta in place (no update tree); returns (params, state).

        ``shardings``: ``{path: NamedSharding}`` of the parameters on a
        mesh (see the module docstring). ``grad_scale``: a scalar (0-d f32
        tensor on the parameters' device, or a Python number) folded into
        the gradient read — the trainer's global-norm clip factor.
        """
        return _step(grads, state, params, write=True, grad_scale=grad_scale,
                     shardings=shardings)

    return GradientTransformation(init, update, update_params,
                                  plans=dict(plans))
