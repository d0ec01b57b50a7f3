"""The cost model behind ``obs.report.cost_estimate`` and
``RunReport.add_cost_analysis``: a tally of the FLOPs and bytes of the
ATen operations one call dispatches.

The JAX package reads XLA's pre-optimization HloCostAnalysis of the
lowered function. The port has no lowering, so it counts the operations
one call runs, under a ``TorchDispatchMode``, by the same rules:

- a product (``mm``, ``bmm``, ``addmm``, a convolution, attention: every
  op ``torch.utils.flop_counter`` has a formula for) counts that formula,
  ``2·M·N·K`` for a product;
- an elementwise op (tag ``pointwise``) counts one FLOP an output element;
- a reduction (tag ``reduction``) counts one FLOP an input element beyond
  the first of each output (XLA's count for a reduce: input elements
  less output elements);
- every other op (copies, indexing, sorts, views) counts none;
- bytes are each op's tensor operands plus its results, and for a
  reduction one element more (the initial value an HLO reduce reads);
  views (aliasing results) move no byte.

The call runs on ``meta`` stand-ins of its tensor arguments where it runs
on them (no data, no device work); otherwise, when a ``meta`` tensor is
refused (a hand-written kernel's wrapper, an op without a ``meta``
kernel), it runs once more on the given arguments. A hand-written kernel's
own work is no ATen operation and is not in the tally. A call that reads
values on the host (``.item()``, ``bool()`` of a tensor, a copy to the
host), as the ``parallel`` turnover scheme does for each sweep's
``max |dw|``, has work that depends on the data: its estimate is the
failure form, NaN fields and an ``error`` naming the read. (The ``scan``
scheme's day loop reads no value through ATen: its synchronizations are
inside the factorizations' kernels, so it is tallied, one extra run of
the whole step.)
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten

#: ops whose results are host values: the call's work depends on them
_HOST_READS = {_aten._local_scalar_dense.default, _aten.is_nonzero.default,
               _aten.equal.default}


class HostRead(RuntimeError):
    """The tallied call read a value on the host."""


def _tensor_bytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v) for v in obj)
    return 0


def _numel(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel()
    if isinstance(obj, (list, tuple)):
        return sum(_numel(v) for v in obj)
    return 0


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def op_cost(func, args, kwargs, out) -> tuple:
    """``(flops, bytes)`` of one dispatched op by the module's rules."""
    from torch.utils.flop_counter import flop_registry

    if _is_view(func):
        return 0, 0
    operands = _tensor_bytes(list(args) + list(kwargs.values()))
    results = _tensor_bytes(out)
    formula = flop_registry.get(func._overloadpacket)
    if formula is not None:
        return int(formula(*args, **kwargs, out_val=out)), operands + results
    tags = func.tags
    if torch.Tag.reduction in tags:
        first = next((a for a in args if isinstance(a, torch.Tensor)), None)
        n_in = first.numel() if first is not None else 0
        # the reduced values (a max's indices are a second result)
        n_out = _numel(out[0] if isinstance(out, (tuple, list)) else out)
        init = (first.element_size() if first is not None else 0)
        return max(n_in - n_out, 0), operands + results + init
    if torch.Tag.pointwise in tags:
        return _numel(out), operands + results
    return 0, operands + results


class _Tally(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise HostRead(f"the call reads a value on the host "
                           f"({func}): its work depends on the data")
        out = func(*args, **kwargs)
        if func is _aten._to_copy.default and isinstance(out, torch.Tensor):
            src = args[0] if args else None
            if (out.device.type == "cpu" and isinstance(src, torch.Tensor)
                    and src.device.type != "cpu"):
                raise HostRead("the call copies a tensor to the host: its "
                               "work depends on the data")
        f, b = op_cost(func, args, kwargs, out)
        self.flops += f
        self.bytes += b
        return out


def _to_meta(obj):
    """``obj`` with every tensor replaced by a ``meta`` tensor of its shape
    and dtype (tuples, lists, dicts, named tuples and dataclasses
    rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj, device="meta")
    if isinstance(obj, dict):
        return {k: _to_meta(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_meta(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_meta(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_meta(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _tally(fn, args, kwargs) -> dict:
    mode = _Tally()
    with mode:
        fn(*args, **kwargs)
    return {"flops": float(mode.flops), "bytes_accessed": float(mode.bytes)}


def estimate(fn, *args, **kwargs) -> dict:
    """``{"flops", "bytes_accessed"}`` of one call of ``fn`` (module docs),
    on ``meta`` stand-ins where it runs on them, else on the given
    arguments; ``{"flops": nan, "bytes_accessed": nan, "error": ...}``
    where it reads host values or fails."""
    try:
        try:
            return _tally(fn, _to_meta(args), _to_meta(kwargs))
        except HostRead:
            raise
        except Exception:
            return _tally(fn, args, kwargs)
    except Exception as e:
        return {"flops": float("nan"), "bytes_accessed": float("nan"),
                "error": f"{type(e).__name__}: {e}"}
