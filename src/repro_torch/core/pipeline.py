"""Staged leaf-update pipeline: the subset of ``repro.core.pipeline`` that
SCALE uses.

A :class:`Stages` value describes what happens to one label group
(``core.labels``: first / last / matrix / vector), in fixed order:

    grad-scale fold -> [momentum EMA] -> [normalize] | [adam] -> lr scale
    -> apply

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
  momentum/adam                           ``norm_update`` (write)
  momentum EMA + ``norm`` in              ``momentum_norm`` (delta) /
  {col,row,larger}                        ``momentum_norm_update`` (write)
  ======================================  ==================================

``grad_scale`` (the trainer's clip factor) goes into the kernels, which
multiply g at read time; plain branches form ``g * grad_scale`` with JAX's
promotion (a bf16 g times an f32 tensor is f32; a Python number is cast to
g's dtype first).

State is :class:`PipeState` ``(count, mu, nu, extra)`` of flat
``{path: tensor}`` dicts: ``mu`` the momentum or Adam first moment
(``momentum_dtype`` for non-vector leaves), ``nu`` the Adam second moment
(f32); buffers a leaf does not use are zero-length f32 placeholders, so
the layout is uniform. Both entry points update the state's tensors in
place (the kernels write the momentum in place, as the TPU's aliasing
does) and return a :class:`PipeState` holding them; ``update_params``
also writes the parameters in place. ``update`` is a shape and dtype fixed
point of ``init``. No step synchronises with the host: lr, gscale and the
step count stay on the device.

Not ported yet (ROADMAP Queue 1 item 8): nesterov, standardize, AdamS,
weight decay, low-rank projections, the ``pre`` hooks and momentum reset;
sharding plans wait for item 12.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.model import flatten

from .labels import LabelRules, label_tree, transposed_tree
from .normalization import flip_kind, normalize, resolve_larger
from .types import GradientTransformation, Schedule

_f32 = torch.float32

_LABELS = ("first", "last", "matrix", "vector")

_NOT_PORTED = ("nesterov", "standardize", "ns_steps", "adams",
               "weight_decay", "project")


def _empty(p):
    return torch.zeros((0,), dtype=_f32, device=p.device)


def _zeros(p, dtype=_f32):
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


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


def _adam_leaf(g, m, v, count, b1, b2, eps):
    gf = g.to(_f32)
    m = b1 * m + (1.0 - b1) * gf
    v = b2 * v + (1.0 - b2) * gf * gf
    mhat = m / (1.0 - b1 ** (count + 1))
    vhat = v / (1.0 - b2 ** (count + 1))
    upd = mhat / (torch.sqrt(vhat) + eps)
    return upd, m, v


@dataclasses.dataclass(frozen=True)
class Stages:
    """Stage composition for one label group.

    ``momentum``  — EMA coefficient of the first-moment stage (0 = off).
    ``norm``      — normalization kind (col/row/larger) of the direction,
                    or None. ``flip_transposed`` flips col<->row for
                    transposed-storage (tied-head) leaves.
    ``adam``      — full Adam on this group; exclusive with momentum/norm.
    ``use_adam_lr`` / ``lr_scaling`` — lr source and Muon's per-matrix lr
                    scale.
    The JAX package's other fields (nesterov, standardize, ns_steps, adams,
    weight_decay, project) are accepted only at their defaults until the
    rest of the optimizer zoo is ported (ROADMAP Queue 1 item 8).
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
    project: Optional[object] = None
    use_adam_lr: bool = False
    lr_scaling: bool = False

    def __post_init__(self):
        fields = {f.name: f.default for f in dataclasses.fields(self)}
        bad = [n for n in _NOT_PORTED if getattr(self, n) != fields[n]]
        if bad:
            raise ValueError(f"Stages fields {bad} are not ported to "
                             "repro_torch yet (ROADMAP Queue 1 item 8, the "
                             "rest of the optimizer zoo)")


ADAM_LR_STAGE = Stages(adam=True, use_adam_lr=True)


class PipeState(NamedTuple):
    count: torch.Tensor  # 0-d int32
    mu: dict             # first moment; zero-length when unused
    nu: dict             # Adam second moment; zero-length when unused
    extra: object = None


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
) -> GradientTransformation:
    """Build a :class:`GradientTransformation` from per-label stage plans.

    ``plans`` maps every label in ``("first", "last", "matrix", "vector")``
    to a :class:`Stages`. ``impl="fused"`` lowers matching compositions to
    the kernels (see the module docstring); ``"jnp"`` is the plain per-leaf
    maths of the JAX package's jnp route. ``momentum_dtype`` sets the
    storage dtype of non-vector first-moment buffers.
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

    def _mu_dtype(lab):
        return _f32 if lab == "vector" else mdt

    def _use_kernel(st, shape, kind) -> bool:
        return (fused and kind is not None and not st.adam
                and _kd.supported(shape, kind))

    def init(params):
        params = flatten(params)
        labels = label_tree(params, rules, require_last=require_last)

        def mk_mu(lab, p):
            st = plans[lab]
            if st.adam or st.momentum:
                return _zeros(p, _mu_dtype(lab))
            return _empty(p)

        def mk_nu(lab, p):
            return _zeros(p) if plans[lab].adam else _empty(p)

        dev = next(iter(params.values())).device if params else None
        return PipeState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: mk_mu(labels[k], p) for k, p in params.items()},
            nu={k: mk_nu(labels[k], p) for k, p in params.items()})

    @torch.no_grad()
    def _step(grads, state, params, write, grad_scale=None):
        """Shared per-leaf routing for both entry points (``write=False``:
        delta mode; ``write=True``: parameters written in place)."""
        grads = flatten(grads)
        params = flatten(params) if params is not None else {}
        count = state.count
        lr_t = _lr_at(lr, count)
        alr_t = _lr_at(adam_lr, count)

        def emit(u, dtype, p):
            # delta mode returns the update rounded to the (scaled)
            # gradient's dtype; write mode applies it
            u = u.to(dtype)
            return u if not write else p.add_(u.to(p.dtype))

        def leaf(lab, tr, g, m, v, p):
            st = plans[lab]
            # plain branches scale g as the trainer's clip tree-map does;
            # kernel branches pass grad_scale into the kernels, which
            # multiply g at read time, and need only the scaled dtype (JAX
            # drops the unused g * grad_scale; eagerly it is a full pass)
            gdt = g.dtype if grad_scale is None else jax_dtype(g, grad_scale)

            def gsc():
                return g if grad_scale is None else jax_mul(g, grad_scale)

            if st.adam:
                upd, m_f, v_f = _adam_leaf(gsc(), m.to(_f32), v, count, b1,
                                           b2, eps)
                m.copy_(m_f)
                v.copy_(v_f)
                lr_eff = alr_t if st.use_adam_lr else lr_t
                return emit(-lr_eff * upd, gdt, p)

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
                                                 gscale=grad_scale)
                        return emit(-lr_eff * d, gdt, p)
                    _kd.momentum_norm_update(p, m, g, st.momentum, lr_eff,
                                             kind, gscale=grad_scale)
                    return p
                gf = gsc().to(_f32)
                # cast-on-read/write: EMA and norm in f32, storage in m's
                # dtype
                d = st.momentum * m.to(_f32) + (1.0 - st.momentum) * gf
                m.copy_(d)
            else:
                if _use_kernel(st, g.shape, kind):
                    if not write:
                        return emit(-lr_eff * _kd.normalize(
                            g, kind, gscale=grad_scale, out_dtype=_f32),
                            gdt, p)
                    return _kd.norm_update(p, g, lr_eff, kind,
                                           gscale=grad_scale)
                d = gsc().to(_f32)

            if kind is not None:
                d = normalize(d, resolve_larger(kind, g.shape))
            return emit(-lr_eff * d, gdt, p)

        labels = label_tree(grads, rules, require_last=require_last)
        tr = (transposed_tree(grads, rules) if rules.tied_last
              else dict.fromkeys(grads, False))
        out = {k: leaf(labels[k], tr[k], g, state.mu[k], state.nu[k],
                       params.get(k))
               for k, g in grads.items()}
        count.add_(1)
        return out, PipeState(count, state.mu, state.nu, state.extra)

    def update(grads, state, params=None):
        return _step(grads, state, params, write=False)

    def update_params(grads, state, params, grad_scale=None):
        """Write theta in place (no update tree); returns (params, state).

        ``grad_scale``: a scalar (0-d f32 tensor on the parameters' device,
        or a Python number) folded into the gradient read — the trainer's
        global-norm clip factor.
        """
        return _step(grads, state, params, write=True, grad_scale=grad_scale)

    return GradientTransformation(init, update, update_params,
                                  plans=dict(plans))
