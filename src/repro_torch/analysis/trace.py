"""The port's "IR": a record of what one eager step actually did.

The JAX package's passes read the lowered StableHLO and the compiled HLO
text of a jitted step (``repro.analysis.stablehlo``, ``hlo``). Eager PyTorch
lowers nothing, so the port's passes read a trace of one step instead:

* every aten call, through a ``TorchDispatchMode`` over the step, forward
  and backward: the op, its operands' and results' dtypes and shapes, which
  results share an operand's storage (views and in-place writes), the op
  that produced each operand, its FLOPs (``torch.utils.flop_counter``'s
  formulas, the ones ``FlopCounterMode`` counts with) and the bytes it
  reads and writes;
* every storage the step holds: each result's storage is held as a
  ``StorageWeakRef`` whose expiry is polled before every op that allocates,
  which gives the op index by which its memory went back to the allocator
  (a death index; memory in use grows only when an op allocates, so the
  peak is the one a poll at every op gives); the step's inputs (the state
  and the batch) are registered before it;
* every launch of the port's hand-written kernels (``record_kernels``):
  the ctypes kernels are invisible to the dispatcher, but their wrappers
  count their launches, and the recorder logs each launch with its shapes.
  A wrapper's call on meta tensors (a dry run, ``launch.dryrun``) stands
  for the launch the card would make and is logged as one; a call on the
  CPU, where the plain version runs, is logged with ``kernel=False``, and
  the plain version's own ops are marked (``OpRecord.in_wrapper``).

On the meta device (a dry run) the same recorder traces one rank's step
with no data: every op, storage and kernel call as the card's, the peak
and FLOPs as the card's trace would give them.

On the card the autograd engine runs the backward on a device thread; the
dispatch mode reaches it through the engine's thread-local state, and
``Trace.require_backward`` fails loudly if the trace holds no op of the
backward pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
from typing import Any, Callable, Iterable, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

NARROW_FLOATS = {"bfloat16", "float16"}
WIDE_FLOATS = {"float32", "float64"}

# ops that move or copy values without changing them (layout, extent, copies)
PASSTHROUGH = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "permute", "transpose", "t",
    "slice", "select", "narrow", "cat", "stack", "clone", "expand", "contiguous",
    "squeeze", "unsqueeze", "alias", "detach", "split", "split_with_sizes", "unbind",
    "as_strided", "flatten", "unflatten", "lift_fresh", "copy", "copy_",
}

# ops whose result is computed from the values (the JAX pass's arithmetic set)
ARITH = {
    "add", "add_", "sub", "sub_", "mul", "mul_", "div", "div_", "neg", "maximum",
    "minimum", "abs", "exp", "sqrt", "rsqrt", "mm", "bmm", "addmm", "baddbmm", "matmul",
    "addcmul", "addcdiv", "lerp", "pow", "reciprocal", "sum", "mean",
}

_CONVERTS = {"_to_copy", "copy_", "copy"}


@dataclasses.dataclass
class OpRecord:
    """One aten call of the step. ``ins``/``outs``: (dtype, shape) of each
    tensor operand / result, dtypes as torch names without the prefix;
    ``alias``: per result, the index of the operand whose storage it shares
    (a view or an in-place write), -1 for fresh memory; ``producers``: per
    operand, the index of the op that produced it (-1: a step input or
    unknown)."""

    index: int
    op: str
    ins: tuple
    outs: tuple
    alias: tuple
    producers: tuple
    device: str
    flops: float
    nbytes: int
    backward: bool
    location: Optional[str] = None
    in_wrapper: bool = False

    @property
    def name(self) -> str:
        """The op's name without namespace and overload: ``aten.mm.default`` → ``mm``."""
        return self.op.split(".")[1] if self.op.count(".") >= 2 else self.op

    def value_operand(self) -> int:
        """The operand whose value the result carries (``copy_``: the source)."""
        return 1 if self.name in ("copy_", "copy") and len(self.ins) > 1 else 0

    def convert(self) -> Optional[tuple]:
        """(source dtype, result dtype) if this op converts a float dtype."""
        if self.name not in _CONVERTS or not self.ins or not self.outs:
            return None
        src, dst = self.ins[self.value_operand()][0], self.outs[0][0]
        if src == dst:
            return None
        return src, dst

    def widening(self) -> bool:
        c = self.convert()
        return c is not None and c[0] in NARROW_FLOATS and c[1] in WIDE_FLOATS

    def narrowing(self) -> bool:
        c = self.convert()
        return c is not None and c[0] in WIDE_FLOATS and c[1] in NARROW_FLOATS


@dataclasses.dataclass
class StorageRecord:
    """One storage the step held: ``birth`` the op that allocated it (-1: a
    step input), ``death`` the op index at which it was found freed (None:
    alive when the step ended)."""

    birth: int
    nbytes: int
    device: str
    death: Optional[int] = None
    input: bool = False


@dataclasses.dataclass
class KernelCall:
    """One call of a hand-written kernel's wrapper: its name and the shapes
    the cost model reads (``cost_model.kernel_bound``). ``kernel``: the
    kernel was launched, or on the meta device would be; False: the plain
    version ran (the CPU)."""

    name: str
    args: dict
    kernel: bool = True


@dataclasses.dataclass
class Tally:
    """A lean trace's running totals, in place of its op and storage lists
    (``recording(lean=True)``, the dry run's: a production rank's step runs
    to millions of ops). The cost terms are ``cost_model.model_step``'s per
    op, summed; ``peak`` is the peak of the bytes live at a birth, the
    inputs' from the start, as ``liveness.peak_hbm``'s sweep gives it."""

    n_ops: int = 0
    n_backward_ops: int = 0
    flops_bf16: float = 0.0
    flops_f32: float = 0.0
    nbytes: int = 0
    compute_s: float = 0.0
    memory_s: float = 0.0
    by_operations_s: float = 0.0
    by_bytes_s: float = 0.0
    param_bytes: int = 0
    live: int = 0
    peak: int = 0


@dataclasses.dataclass
class Trace:
    device: str
    ops: list = dataclasses.field(default_factory=list)
    storages: list = dataclasses.field(default_factory=list)
    kernels: list = dataclasses.field(default_factory=list)
    tally: Optional[Tally] = None

    @property
    def n_backward_ops(self) -> int:
        if self.tally is not None:
            return self.tally.n_backward_ops
        return sum(op.backward for op in self.ops)

    @property
    def n_ops(self) -> int:
        return self.tally.n_ops if self.tally is not None else len(self.ops)

    def require_backward(self) -> None:
        """Raise unless the trace holds ops of the autograd backward pass."""
        if not self.n_backward_ops:
            raise RuntimeError(
                f"the trace of {len(self.ops)} ops holds no op of the backward pass: the "
                "dispatch mode did not reach the autograd engine's thread")

    def flops(self) -> float:
        if self.tally is not None:
            return float(self.tally.flops_bf16 + self.tally.flops_f32)
        return float(sum(op.flops for op in self.ops))


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (NotImplementedError, RuntimeError):     # sparse, nested: no one storage
        return None


_expired = torch.UntypedStorage._expired      # a storage weak ref's cdata → freed?


def _tensors(x) -> list:
    """The tensors of an aten call's arguments or results: tensors, and
    tensors in lists, tuples and dicts (one level deep, as aten passes them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return []
    out = []
    for v in x:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _location() -> Optional[str]:
    """The innermost frame of the port outside this package: "path:line"."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename.replace("\\", "/")
        i = fn.rfind("/repro_torch/")
        if i >= 0 and "/repro_torch/analysis/" not in fn:
            return f"src{fn[i:]}:{f.f_lineno}"
        f = f.f_back
    return None


def _flops(func, args, kwargs, out) -> float:
    """The op's FLOPs by ``torch.utils.flop_counter``'s formula (0 for ops
    it does not count). ``mm.dtype``/``bmm.dtype`` (a bf16 product with f32
    output) count as the product of their two operands: their ``out_dtype``
    argument would land on the formula's ``out_shape``."""
    formula = flop_registry.get(func._overloadpacket)
    if formula is None:
        return 0.0
    if func._overloadname == "dtype":
        args, kwargs = args[:2], {}
    return float(formula(*args, **kwargs, out_val=out))


class _Recorder(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace
        self.producer = WeakIdKeyDictionary()   # tensor → index of the op that made it
        self.writer: dict = {}                  # storage cdata → op that last wrote it
        # storage cdata → (weak ref, StorageRecord); the weak ref keeps the
        # StorageImpl's address from being reused while it is tracked
        self.live: dict = {}
        self.polled = -1

    def register(self, tensors: Iterable[torch.Tensor]) -> None:
        """Storages that exist before the step (its inputs)."""
        for t in tensors:
            st = _storage(t)
            if st is not None and st._cdata not in self.live:
                rec = StorageRecord(-1, st.nbytes(), t.device.type, input=True)
                self.trace.storages.append(rec)
                self.live[st._cdata] = (StorageWeakRef(st), rec)

    def _poll(self, i: int) -> None:
        dead = [c for c in self.live if _expired(c)]
        for c in dead:
            self.live.pop(c)[1].death = i
            self.writer.pop(c, None)

    def _track(self, t: torch.Tensor, i: int) -> Optional[int]:
        """The storage of ``t``, registered as born at op ``i`` if new. The
        live set is polled for deaths only before a birth: memory in use
        grows only at a birth, so the peak is the same as with a poll at
        every op."""
        st = _storage(t)
        if st is None:
            return None
        c = st._cdata
        if c not in self.live:
            if self.polled != i:
                self._poll(i)
                self.polled = i
            rec = StorageRecord(i, st.nbytes(), t.device.type)
            self.trace.storages.append(rec)
            self.live[c] = (StorageWeakRef(st), rec)
        return c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        i = len(self.trace.ops)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        in_store = [self._track(t, i) for t in ins]
        producers = []
        for t, c in zip(ins, in_store):
            p = self.producer.get(t)
            producers.append(p if p is not None else self.writer.get(c, -1))
        alias, nbytes = [], 0
        for o in outs:
            c = self._track(o, i)
            a = next((k for k, ci in enumerate(in_store) if c is not None and ci == c), -1)
            alias.append(a)
            self.producer[o] = i
            if c is not None:
                self.writer[c] = i
        packet = func._overloadpacket
        flops = _flops(func, args, kwargs, out)
        if any(a < 0 for a in alias) or packet.__name__.endswith("_"):
            nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
        dev = (outs or ins)[0].device.type if (outs or ins) else "cpu"
        rec = OpRecord(i, str(func), tuple((_dtype(t), tuple(t.shape)) for t in ins),
                       tuple((_dtype(t), tuple(t.shape)) for t in outs), tuple(alias),
                       tuple(producers), dev, flops, nbytes,
                       torch._C._current_autograd_node() is not None,
                       in_wrapper=_IN_WRAPPER[0] > 0)
        if rec.convert() is not None:
            rec.location = _location()
        self.trace.ops.append(rec)
        return out

    def __exit__(self, *exc):
        self._poll(len(self.trace.ops))
        return super().__exit__(*exc)


class _Tallier(TorchDispatchMode):
    """The lean recorder: each op priced and summed as it runs (``Tally``),
    the storages' bytes live tracked for the peak alone.

    A storage's death is seen by polling its weak ref. Polling every live
    storage at every birth costs O(live) an op; here a birth polls only
    when the bytes it may find live (every storage not yet seen dead) would
    pass the peak so far (else the peak cannot move), first the storages
    born since the last full poll, then, if the bound still passes it, all
    of them. The peak is the same as a poll at every birth gives."""

    def __init__(self, trace: Trace):
        super().__init__()
        from repro_torch.analysis import cost_model
        self.hw = cost_model.HW
        self.trace = trace
        self.t = trace.tally = Tally()
        self.old: dict = {}          # storage cdata → (weak ref, bytes)
        self.young: dict = {}

    def register(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            st = _storage(t)
            if st is not None and st._cdata not in self.old and t.device.type == self.trace.device:
                self.old[st._cdata] = (StorageWeakRef(st), st.nbytes())
                self.t.live += st.nbytes()
                self.t.param_bytes += st.nbytes()
        self.t.peak = self.t.live

    def _sweep(self, pool: dict) -> None:
        dead = [c for c in pool if _expired(c)]
        for c in dead:
            self.t.live -= pool.pop(c)[1]

    def _birth(self, st) -> None:
        n = st.nbytes()
        t = self.t
        if t.live + n > t.peak:
            self._sweep(self.young)
            if t.live + n > t.peak:
                self._sweep(self.old)
                self.old.update(self.young)
                self.young.clear()
        self.young[st._cdata] = (StorageWeakRef(st), n)
        t.live += n
        t.peak = max(t.peak, t.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        fresh = False
        in_store = set()
        for x in ins:                # as the full recorder: an unseen input is born here
            st = _storage(x)
            if st is None:
                continue
            in_store.add(st._cdata)
            if x.device.type == self.trace.device and st._cdata not in self.young \
                    and st._cdata not in self.old:
                self._birth(st)
        for o in outs:
            st = _storage(o)
            if st is None:
                fresh = True
                continue
            c = st._cdata
            if c in in_store:
                continue
            fresh = True
            if o.device.type == self.trace.device and c not in self.young and c not in self.old:
                self._birth(st)
        t = self.t
        t.n_ops += 1
        t.n_backward_ops += torch._C._current_autograd_node() is not None
        dev = (outs or ins)[0].device.type if (outs or ins) else "cpu"
        if dev != self.trace.device:
            return out
        flops = _flops(func, args, kwargs, out)
        nbytes = 0
        if fresh or func._overloadpacket.__name__.endswith("_"):
            nbytes = sum(x.numel() * x.element_size() for x in (*ins, *outs))
        dt = _dtype(ins[0]) if ins else (_dtype(outs[0]) if outs else "float32")
        narrow = dt in NARROW_FLOATS
        t_c = flops / self.hw["peak_flops_bf16" if narrow else "peak_flops_f32"]
        t_m = nbytes / self.hw["hbm_bw"]
        if narrow:
            t.flops_bf16 += flops
        else:
            t.flops_f32 += flops
        t.nbytes += nbytes
        t.compute_s += t_c
        t.memory_s += t_m
        if t_c > t_m:
            t.by_operations_s += t_c
        else:
            t.by_bytes_s += t_m
        return out


def tensors_of(tree: Any) -> list:
    """Every tensor in a nested structure of dicts, lists, tuples, dataclass
    instances and objects with tensor attributes (the TrainState, a batch)."""
    out, seen = [], set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__") and id(x) not in seen:
            seen.add(id(x))
            for v in vars(x).values():
                walk(v)
    walk(tree)
    return out


@contextlib.contextmanager
def recording(device, inputs: Any = (), lean: bool = False):
    """``with recording(device, inputs) as trace:`` records every aten call
    made inside (the backward included) into ``trace``; the storages of
    ``inputs`` (any nest of tensors) count as held from the start.
    ``lean``: totals only (``Tally``), no op or storage list."""
    trace = Trace(torch.device(device).type)
    rec = (_Tallier if lean else _Recorder)(trace)
    rec.register(tensors_of(inputs))
    with rec:
        yield trace


def record_step(step: Callable, state: Any, batch: Any, *, device, lean: bool = False) -> tuple:
    """Run ``step(state, batch)`` once under the recorder and the kernel log
    → (its output, the Trace). The state and the batch are the inputs."""
    with record_kernels() as calls, recording(device, (state, batch), lean) as trace:
        out = step(state, batch)
    trace.kernels = calls
    return out, trace


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------

KERNELS = (
    ("repro_torch.kernels.flash_attention.flash_attention", "flash_fwd"),
    ("repro_torch.kernels.flash_attention.flash_attention", "flash_bwd_dq"),
    ("repro_torch.kernels.flash_attention.flash_attention", "flash_bwd_dkv"),
    ("repro_torch.kernels.collage_update.collage_update", "collage_bucket_update"),
    ("repro_torch.kernels.edq.edq", "edq_partials"),
)


def _kernel_args(name: str, args: tuple, kwargs: dict) -> dict:
    if name.startswith("flash"):
        q, k = args[0], args[1]
        B, H, L, dh = q.shape
        return dict(B=B, H=H, Hkv=k.shape[1], L=L, dh=dh,
                    causal=bool(kwargs.get("causal", True)), window=int(kwargs.get("window", 0)))
    if name == "collage_bucket_update":
        return dict(n=args[1].numel(), code=kwargs.get("strategy", "C"))
    return dict(n=args[0].numel())


_IN_WRAPPER = [0]          # depth of kernel-wrapper calls the recorder is inside


def _logging(orig: Callable, name: str, log: list) -> Callable:
    def wrapper(*args, **kwargs):
        before = (wrapper.launches, wrapper.meta_calls)
        _IN_WRAPPER[0] += 1
        try:
            out = orig(*args, **kwargs)
        finally:
            _IN_WRAPPER[0] -= 1
        kernel = (wrapper.launches, wrapper.meta_calls) != before
        log.append(KernelCall(name, _kernel_args(name, args, kwargs), kernel))
        return out
    wrapper.launches, wrapper.meta_calls = orig.launches, orig.meta_calls
    return wrapper


@contextlib.contextmanager
def record_kernels():
    """``with record_kernels() as calls:`` logs every kernel wrapper call
    inside (``KernelCall.kernel``: a launch, or a meta call).

    Each wrapper counts its launches (and meta calls) in its own
    attributes, which it reaches through its module's global name; the log
    puts a logging wrapper under that name, and the wrapper's counts are
    handed back to the original when the block ends, so no launch is lost
    or counted twice."""
    log: list = []
    swapped = []
    for modname, name in KERNELS:
        mod = importlib.import_module(modname)
        orig = getattr(mod, name)
        wrapper = _logging(orig, name, log)
        setattr(mod, name, wrapper)
        swapped.append((mod, name, orig, wrapper))
    try:
        yield log
    finally:
        for mod, name, orig, wrapper in swapped:
            orig.launches, orig.meta_calls = wrapper.launches, wrapper.meta_calls
            setattr(mod, name, orig)
