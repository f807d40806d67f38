"""Carry the reference's data into the port.

The port never imports JAX: the caller turns the reference's arrays into
numpy (``np.asarray``) and hands them over.  Used by the parity tests so
that both packages start from identical problem data and iterates.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from .chained import ChainInfo, flat_callables
from .parallel import scenario as _scenario
from .sparse import BandedInfo
from .linalg.nested_dissection import NDInfo, NDLevel
from .options import Options
from .problem import ARRAY_FIELDS, CanonicalNLP, CanonicalStructure
from .types import Iterate


def options_from_dict(d: Mapping[str, Any]) -> Options:
    """``Options`` from ``dataclasses.asdict`` of a reference ``Options``."""
    return Options().replace(**dict(d))


_STRUCT_FIELDS = ("n_full", "n", "m", "me", "mi", "eq_idx", "ineq_idx",
                  "free_idx", "fixed_idx", "fixed_treatment")


def _tensor(v, device, dtype, batched):
    a = np.array(v)
    t = torch.as_tensor(a, device=device)
    if t.is_floating_point():
        t = t.to(dtype)
    return t if batched else t[None]


def _tensor_tree(v, device, dtype, batched):
    if isinstance(v, dict):
        return {k: _tensor_tree(t, device, dtype, batched) for k, t in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_tensor_tree(t, device, dtype, batched) for t in v)
    return _tensor(v, device, dtype, batched)


def canonical_from_arrays(struct_fields: Mapping[str, Any],
                          arrays: Mapping[str, Any], f: Callable,
                          g: Optional[Callable], device="cpu",
                          dtype=torch.float64) -> CanonicalNLP:
    """A port ``CanonicalNLP`` from a reference ``CanonicalNLP``'s static
    structure (its dataclass fields) and array leaves (as numpy, keyed by
    field name), with torch callables ``f(x_full, params)`` and
    ``g(x_full, params)``.  Unbatched leaves (x0 of rank 1) get a batch axis
    of one."""
    struct = CanonicalStructure(
        **{k: struct_fields[k] for k in _STRUCT_FIELDS},
        **{k: float(struct_fields.get(k, 0.0)) for k in ("fd_grad_eps", "fd_jac_eps")})
    batched = np.asarray(arrays["x0"]).ndim == 2
    vals = {}
    for name in ARRAY_FIELDS:
        v = arrays.get(name, ())
        if name == "params" and (v is None or v == ()):
            vals[name] = ()
        else:
            vals[name] = _tensor_tree(v, device, dtype, batched)
    return CanonicalNLP(struct=struct, f=f, g=g, **vals)


def chained_from_arrays(struct_fields: Mapping[str, Any],
                        arrays: Mapping[str, Any],
                        chain_fields: Mapping[str, Any], f_stage: Callable,
                        g_stage: Callable, f_last: Optional[Callable] = None,
                        device="cpu", dtype=torch.float64) -> CanonicalNLP:
    """A port chained ``CanonicalNLP`` from a reference one: its structure
    and arrays as for ``canonical_from_arrays`` (``params`` is
    ``{"theta": ...}``), the ``ChainInfo`` fields ``K, v, mk, eq_mask``, and
    the port's torch stage callables."""
    info = ChainInfo(K=int(chain_fields["K"]), v=int(chain_fields["v"]),
                     mk=int(chain_fields["mk"]), f_stage=f_stage,
                     g_stage=g_stage, f_last=f_last,
                     eq_mask=np.asarray(chain_fields["eq_mask"], dtype=bool))
    f, g = flat_callables(info.K, info.v, f_stage, g_stage, f_last)
    return canonical_from_arrays(struct_fields, arrays, f, g, device=device,
                                 dtype=dtype)._replace(chain=info)


def scenario_from_arrays(struct_fields: Mapping[str, Any],
                         arrays: Mapping[str, Any],
                         arrow_fields: Mapping[str, Any], f_scen: Callable,
                         g_scen: Callable, f0: Optional[Callable] = None,
                         device="cpu", dtype=torch.float64) -> CanonicalNLP:
    """A port scenario ``CanonicalNLP`` from a reference one: its structure
    and arrays as for ``canonical_from_arrays`` (``params`` is
    ``{"theta": ...}``), the ``ArrowInfo`` fields ``S, n0, ns, ms,
    eq_mask``, and the port's torch scenario callables."""
    info = _scenario.ArrowInfo(
        S=int(arrow_fields["S"]), n0=int(arrow_fields["n0"]),
        ns=int(arrow_fields["ns"]), ms=int(arrow_fields["ms"]), f_scen=f_scen,
        g_scen=g_scen, f0=f0,
        eq_mask=np.asarray(arrow_fields["eq_mask"], dtype=bool))
    f, g = _scenario.flat_callables(info.S, info.n0, info.ns, f_scen, g_scen, f0)
    return canonical_from_arrays(struct_fields, arrays, f, g, device=device,
                                 dtype=dtype)._replace(chain=info)


def lbfgs_from_arrays(S, Y, count, head, sigma, skips, device="cpu",
                      dtype=torch.float64):
    """A port ``LBFGSState`` from a reference one's fields, as numpy: S and Y
    (n, hist) and the scalars of one history get a batch axis of one;
    already batched fields (B, n, hist) and (B,) pass as they are."""
    from .algorithm.quasi_newton import LBFGSState
    batched = np.asarray(S).ndim == 3

    def t(v, floating):
        a = torch.as_tensor(np.array(v), device=device)
        a = a.to(dtype) if floating else a.to(torch.int64)
        return a if batched else a[None]

    return LBFGSState(S=t(S, True), Y=t(Y, True), count=t(count, False),
                      head=t(head, False), sigma=t(sigma, True),
                      skips=t(skips, False))


def iterate_from_arrays(blocks: Sequence[Any], device="cpu",
                        dtype=torch.float64) -> Iterate:
    """A port ``Iterate`` from the eight blocks (x, s, y_c, y_d, z_L, z_U,
    v_L, v_U) of a reference iterate, as numpy; rank-1 blocks get a batch
    axis of one."""
    batched = np.asarray(blocks[0]).ndim == 2
    return Iterate(*(_tensor(b, device, dtype, batched) for b in blocks))


def params_from_arrays(params, device="cpu", dtype=torch.float64):
    """A port ``params`` tree (dicts, tuples and lists of (B, ...) tensors)
    from a reference ``params`` pytree of one instance, as numpy leaves:
    every leaf gets a batch axis of one."""
    return _tensor_tree(params, device, dtype, batched=False)


def sensitivity_from_arrays(blocks: Sequence[Any], device="cpu",
                            dtype=torch.float64):
    """A port ``sens.SensitivityResult`` from the eight blocks (dx, ds, dy_c,
    dy_d, dz_L, dz_U, dv_L, dv_U) of a reference one, as numpy; rank-1
    blocks get a batch axis of one."""
    from .sens import SensitivityResult
    return SensitivityResult(*iterate_from_arrays(blocks, device, dtype))


_BANDED_INTS = ("n", "mi", "me", "N", "b", "nb", "n_colors_j", "n_colors_h", "n_pad",
                "n_vals")
_BANDED_ARRAYS = ("perm", "pos", "j_rows", "j_cols", "j_colors", "h_rows", "h_cols",
                  "h_colors", "row_unknown", "asm_slot", "asm_src", "asm_inv",
                  "diag_kind")
# the reference keeps these on the object under private names
_BANDED_MASKS = (("h_keep", "_h_keep_mask"), ("j_mirror", "_j_mirror_mask"),
                 ("s_mirror", "_s_mirror_mask"))


def banded_info_from_reference(info) -> BandedInfo:
    """The port's ``BandedInfo`` from the reference's (``ipopt_tpu.sparse``),
    its restoration analysis included; every array is copied as numpy."""
    def arr(v):
        return None if v is None else np.array(v)

    fields = {k: int(getattr(info, k)) for k in _BANDED_INTS}
    fields.update({k: arr(getattr(info, k)) for k in _BANDED_ARRAYS})
    fields.update({k: arr(getattr(info, ref, None)) for k, ref in _BANDED_MASKS})
    resto = getattr(info, "_resto_info", None)
    fields["resto"] = None if resto is None else banded_info_from_reference(resto)
    return BandedInfo(**fields)


_ND_INTS = ("n", "mi", "me", "N", "n_colors_j", "n_colors_h", "total_slots",
            "n_pad_elim", "n_vals")
_ND_ARRAYS = ("j_rows", "j_cols", "j_colors", "h_rows", "h_cols", "h_colors",
              "row_unknown", "asm_src")
_ND_LEVEL_ARRAYS = ("elim_gid", "bd_gid", "child_scatter", "diag_kind")


def nd_info_from_reference(info) -> NDInfo:
    """The port's ``NDInfo`` from the reference's
    (``ipopt_tpu.linalg.nested_dissection``), its restoration analysis
    included; every array is copied as numpy."""
    fields = {k: int(getattr(info, k)) for k in _ND_INTS}
    fields.update({k: np.array(getattr(info, k)) for k in _ND_ARRAYS})
    inv = np.asarray(info.asm_inv)
    fields["asm_slot"] = np.flatnonzero(inv < fields["asm_src"].shape[0])
    fields.update({k: tuple(np.array(a) for a in getattr(info, k))
                   for k in _ND_LEVEL_ARRAYS})
    fields["levels"] = tuple(NDLevel(*(int(v) for v in lv)) for lv in info.levels)
    resto = getattr(info, "_resto_info", None)
    fields["resto"] = None if resto is None else nd_info_from_reference(resto)
    return NDInfo(**fields)
