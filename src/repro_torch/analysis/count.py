"""The work of a step, counted op by op: the port's stand-in for XLA's
``compiled.cost_analysis()`` and ``memory_analysis()``.

PyTorch compiles no program to read, so ``StepCounter`` watches one run
of the step instead.  It is a ``TorchDispatchMode`` used as a context
manager; the step runs inside it on ``meta`` tensors (no memory, no
time: the dry-run) or on the card's (the same count, checked against
the meta one):

* **FLOPs** of every aten op that ``torch.utils.flop_counter`` has a
  formula for (the matrix products: mm, addmm, bmm, baddbmm); elementwise
  ops count none, and their elements ride along as ``elementwise``.
* **Bytes** of every aten op: each tensor input read once and each
  output written once, XLA's sense of ``"bytes accessed"``.  Views,
  ``empty`` and its kin move nothing and count 0; ``copy_`` does not
  read its destination.
* **Transcendentals**: the output elements of exp, log, tanh, sigmoid,
  softmax and their kin.
* **The hand-written kernels**, which are no aten ops: each wrapper calls
  ``kernels.record_kernel(name, flops, bytes)`` with its kernel's work, from a
  formula over shapes (``work()`` in each kernel's ``ops.py``), at every
  launch while a counter is active, on the card as on ``meta``; on
  ``meta`` the wrapper launches nothing and returns outputs of the right
  shape.  ``kernels.scope(name)`` attributes the ops of a plain-products
  backward (``flash_attention_bwd``, ``moe_gmm_bwd``) to that name.
* **Live bytes**: each storage that an op allocates is held from its
  creation to its release (``weakref.finalize`` on the storage, whose
  Python object PyTorch keeps while any tensor still uses it, autograd's
  saved tensors included).  The peak stands in for
  ``temp_size_in_bytes``.

``cost()`` gives the reference's keys (``flops``, ``bytes accessed``,
``transcendentals``); ``memory_stats(...)`` the ``*_size_in_bytes`` keys,
the arguments, outputs and aliases being the caller's to state;
``by_family`` and ``by_op`` the breakdowns (``matmul``, each kernel or
scope by name, ``other``).
"""

from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _COUNTERS, active, record_kernel, scope

aten = torch.ops.aten

# ops that move no bytes: allocations without a write, and shape changes
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided, aten.lift_fresh,
             aten._local_scalar_dense}
_TRANSCENDENTAL = {aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p,
                   aten.log2, aten.tanh, aten.sigmoid, aten.silu,
                   aten.gelu, aten.rsqrt, aten.sqrt, aten.erf, aten.sin,
                   aten.cos, aten.pow, aten._softmax, aten._log_softmax,
                   aten.softplus, aten.logsumexp, aten.tanh_backward,
                   aten.sigmoid_backward, aten.silu_backward,
                   aten._softmax_backward_data,
                   aten._log_softmax_backward_data}

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(obj, out: list) -> list:
    """The tensors of an op's (nested) arguments or results, in order."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


@functools.lru_cache(maxsize=None)
def _op_kind(func):
    """(packet, has a FLOP formula, moves no bytes, transcendental) of an
    aten overload: a view returns an alias it does not write."""
    packet = func.overloadpacket
    rets = func._schema.returns
    view = bool(rets) and rets[0].alias_info is not None \
        and not rets[0].alias_info.is_write
    return (packet, packet in flop_registry, view or packet in _NO_BYTES,
            packet in _TRANSCENDENTAL)


class StepCounter(TorchDispatchMode):
    """Counts the aten ops (and the kernels' recorded work) of the code
    run inside ``with StepCounter() as c:``."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.elementwise = 0.0
        self.by_family: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0, "calls": 0})
        self.by_op: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"flops": 0.0, "bytes": 0.0, "calls": 0})
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self.scopes: List[str] = []   # kernels.scope's names, innermost last

    # -- the context ---------------------------------------------------
    def __enter__(self):
        _COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _COUNTERS.remove(self)

    # -- accounting ----------------------------------------------------
    def add(self, family: str, flops: float, nbytes: float,
            calls: int = 0) -> None:
        self.flops += flops
        self.bytes += nbytes
        fam = self.by_family[family]
        fam["flops"] += flops
        fam["bytes"] += nbytes
        fam["calls"] += calls

    def _hold(self, t: torch.Tensor, inputs: set) -> None:
        """Count a storage live from its first output to its release;
        views of a storage made before the counter are not its own."""
        key = _storage_key(t)
        if key in self._live or key in inputs:
            return
        n = t.untyped_storage().nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t.untyped_storage(), self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet, has_flops, no_bytes, transcendental = _op_kind(func)
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        flops = 0.0
        if has_flops:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        if no_bytes:
            nbytes = 0
        else:
            if packet is aten.copy_:
                ins = ins[1:]          # the destination is written only
            nbytes = sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
            if not flops:
                self.elementwise += sum(o.numel() for o in outs)
        if transcendental:
            self.transcendentals += sum(o.numel() for o in outs)
        family = self.scopes[-1] if self.scopes else (
            "matmul" if flops else "other")
        self.add(family, flops, nbytes, calls=0 if self.scopes else 1)
        rec = self.by_op[str(packet)]
        rec["flops"] += flops
        rec["bytes"] += nbytes
        rec["calls"] += 1
        in_keys = {_storage_key(t) for t in ins}
        for o in outs:
            self._hold(o, in_keys)
        return out

    # -- the reference's dictionaries ------------------------------------
    def cost(self) -> Dict[str, float]:
        """``compiled.cost_analysis()``'s keys."""
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "transcendentals": self.transcendentals}

    def memory_stats(self, *, argument_bytes: float = 0,
                     output_bytes: float = 0,
                     alias_bytes: float = 0) -> Dict[str, int]:
        """``compiled.memory_analysis()``'s keys: the arguments, outputs
        and aliases as the caller states them (the counter cannot tell
        them apart), the peak live bytes as the temporaries."""
        return {"generated_code_size_in_bytes": 0,
                "argument_size_in_bytes": int(argument_bytes),
                "output_size_in_bytes": int(output_bytes),
                "alias_size_in_bytes": int(alias_bytes),
                "temp_size_in_bytes": int(self.peak_bytes)}

    def families(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in sorted(self.by_family.items())}

    def ops(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in sorted(self.by_op.items())}


__all__ = ["StepCounter", "active", "record_kernel", "scope"]
