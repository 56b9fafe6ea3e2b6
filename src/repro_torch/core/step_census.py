"""Per-device instruction and traffic census of a traced PyTorch step —
the port's counterpart of ``repro/core/hlo_counters.py``'s ``Census`` and
``census_from_compiled``.

The JAX census parses the HLO text of a compiled SPMD program.  The port
has no compiler between the model and the card: its step is eager, one
ATen op after another.  ``census_of_step(fn, *args, **kwargs)`` runs
``fn`` once on fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage, nothing allocated) under a ``TorchDispatchMode`` that sees every
ATen op of the step, the backward's included, and counts it.  Under a
device mesh the arguments are DTensors over fake local shards and a fake
process group, and the mode counts what one device does: the ops on its
local shards and the functional collectives DTensor issues between them.

Two things DTensor does must not be counted, and are not:

* DTensor's own op is seen by the mode with global shapes; the mode
  hands it back (``NotImplemented``) and counts the local ops that
  DTensor then runs.
* DTensor's sharding propagation runs each new op once more on fake
  tensors of the GLOBAL shape to learn the output's shape
  (``ShardingPropagator._propagate_tensor_meta_non_cached``).  While
  ``census_of_step`` runs, that method runs with every dispatch mode
  off, so neither the census nor the ``FlopCounterMode`` beside it sees
  those ops.  Without this a (64, 4096) x (4096, 4096) propagation
  product would sit beside each local (4, 4096) x (4096, 256) one on a
  16 x 16 mesh (``tests/test_torch_step_census.py``).  A torch without
  that method is refused by name.

Field names follow the JAX ``Census`` wherever the meaning carries over
(``flops``, ``hbm_bytes``, ``layout_bytes``, ``irregular_bytes``,
``scalar_ops``, ``opcode_counts``, ``class_counts``, ``collectives``,
``collective_wire_bytes``, ``total_instructions``, ``merge_scaled``).
The two instruction-bearing unit classes are the H100's:

    JAX (TPU)            port (H100)
    mxu_flops            tc_flops          tensor-core FLOPs
    mxu_issues           tc_issues         m16n8k16 mma issues, ceil-tiled
    mxu_flops_padded     tc_flops_padded   tc_issues x 4096
    vpu_flops            warp_flops        1 FLOP an element
    vpu_issues           warp_issues       ceil(elements / 32) an op

The rules, op by op (class in ``class_counts``, op in ``opcode_counts``):

* **tc**: every op with a formula in ``torch.utils.flop_counter``'s
  registry (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the convolutions,
  the SDPA kernels).  FLOPs are the registry's, on the local shapes.
  ``mm``/``addmm``/``bmm``/``baddbmm`` are ceil-tiled as ceil(M/16) x
  ceil(N/8) x ceil(K/16) issues (a batch of them times the batch), so a
  decode row of M = 1 uses 1/16 of each tile, the paper's transaction
  count as the JAX census ceil-tiles the MXU; every other tc op is
  counted as ceil(FLOPs / 4096) issues (no padding seen).  f32 products
  count here too, as every dot counts on the MXU in the JAX census; the
  card runs them on its CUDA cores with TF32 off, so they are also
  summed apart in ``tc_flops_f32`` (an op whose output is f32 or f64),
  which ``core/roofline.py`` prices at the f32 peak.
* **collective**: each ``_c10d_functional`` collective, its group size
  read from its group: all-gather moves (g-1)/g of its result over the
  wire, all-reduce 2(g-1)/g, reduce-scatter and all-to-all (g-1)/g of
  the operand, anything else its result (``hlo_counters.py:776-795``).
  Its operand and result bytes count as HBM bytes too, as they do
  there.  ``wait_tensor`` is free.
* **free**: views (``OpOverload.is_view``, ``_unsafe_view``) and
  ``empty*``: no traffic, no issue.  ``prim`` metadata queries are not
  ops and are not counted at all.
* **fill**: factories and in-place fills (``zeros``, ``full``,
  ``arange``, ``fill_``, ``zero_``, random draws): the output written.
* **layout**: ``clone`` (``contiguous`` and a copying ``permute`` or
  ``reshape`` land here), ``copy_``, ``cat``, ``stack``, ``repeat``,
  padding, ``*_scatter`` of slices, ``flip``, ``roll``: inputs read and
  output written (``copy_``: its source read and its destination
  written), also in ``layout_bytes``, and ceil(elements / 32) warp
  issues, as layout still costs vreg issues in the JAX census.
* **irregular**: gathers (``gather``, ``index_select``, ``index``,
  ``embedding``, ``take``) move 2 x their result + the index stream,
  in-place scatters (``index_put_``, ``scatter_add_``, ...) 2 x their
  updates + the index stream, the JAX census's rules; an out-of-place
  scatter, which copies the tensor it scatters into, moves its inputs
  and output; also in ``irregular_bytes``; one FLOP and ceil(n / 32)
  warp issues over the moved elements (result or updates).
* **scalar**: an op with a 0-d result (a loss, a norm): one scalar op
  and its inputs and output in bytes, as the JAX census counts a
  scalar-result instruction.
* **warp**: every other op, elementwise or a reduction: max(result
  elements, largest input's elements) FLOPs and ceil(that / 32) warp
  issues; its inputs read and output written.

**HBM bytes** follow an eager op-boundary model: each counted op reads
every tensor input once and writes every output once (a broadcast
input at most its storage), which is what the port's eager step does on
the card.  XLA's model in the JAX census counts traffic at fusion
boundaries only, so an elementwise chain fused into one kernel there is
one read and one write, and the eager count is the larger.

**Peak live bytes**: the arguments' local storages, then each new output
storage added when an op makes it and taken away when it is freed
(``weakref.finalize`` on the storage); the census keeps the largest sum.

**FLOP counter**: a ``torch.utils.flop_counter.FlopCounterMode`` runs
beneath the census mode over the same local ops; its total
(``flop_counter_flops``) is the independent cross-check of ``tc_flops``
(equal when every product is in its registry and none decomposes).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Iterable, List

import torch

WARP_LANES = 32                      # a warp
MMA_M, MMA_N, MMA_K = 16, 8, 16       # one tensor-core issue
FLOPS_PER_MMA = 2 * MMA_M * MMA_N * MMA_K

_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "set_",
         "resize_", "wait_tensor", "_to_dtype_layout_", "record_stream"}
_FILL = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
         "fill_", "zero_", "new_zeros", "new_ones", "new_full",
         "scalar_tensor", "arange", "linspace", "rand", "randn", "randint",
         "rand_like", "randn_like", "normal_", "uniform_", "exponential_",
         "bernoulli_", "random_", "eye"}
_LAYOUT = {"clone", "copy_", "cat", "stack", "repeat", "constant_pad_nd",
           "narrow_copy", "slice_scatter", "select_scatter",
           "diagonal_scatter", "as_strided_scatter", "flip", "roll",
           "permute_copy", "transpose_copy", "expand_copy", "_reshape_copy",
           "_copy_from", "_copy_from_and_resize"}
_GATHER = {"gather", "index_select", "index", "embedding", "take"}
_SCATTER = {"scatter", "scatter_", "scatter_add", "scatter_add_",
            "scatter_reduce", "scatter_reduce_", "index_put", "index_put_",
            "_index_put_impl_", "_index_put_impl", "index_add",
            "index_add_", "index_copy", "index_copy_", "index_fill",
            "index_fill_", "masked_scatter", "masked_scatter_",
            "embedding_dense_backward"}
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional")


@dataclasses.dataclass
class CollectiveStat:
    kind: str
    count: float = 0.0
    operand_bytes: float = 0.0       # payload size (result for all-gather)
    wire_bytes: float = 0.0          # ring-model bytes on the wire per device


@dataclasses.dataclass
class Census:
    """Per-device instruction and traffic census of one traced step."""

    flops: float = 0.0               # tc_flops + warp_flops
    tc_flops: float = 0.0
    tc_flops_f32: float = 0.0        # of tc_flops, f32 (or f64) products
    warp_flops: float = 0.0          # 1 FLOP an element
    hbm_bytes: float = 0.0           # eager op-boundary traffic model
    layout_bytes: float = 0.0        # subset of hbm_bytes moved by layout ops
    irregular_bytes: float = 0.0     # gather/scatter traffic
    tc_issues: float = 0.0           # m16n8k16 issues (ceil-tiled)
    tc_flops_padded: float = 0.0     # issues x 4096
    warp_issues: float = 0.0         # ceil(elements / 32) an op
    scalar_ops: float = 0.0          # 0-d results
    opcode_counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    class_counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    collectives: Dict[str, CollectiveStat] = dataclasses.field(
        default_factory=dict)
    # tensor-core ops by (op, FLOPs of one): the GEMM mix, op by op
    tc_op_flops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # the trace's memory (bytes of local storages)
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    peak_live_bytes: float = 0.0
    # FlopCounterMode's total over the same local ops
    flop_counter_flops: float = 0.0

    @property
    def collective_wire_bytes(self) -> float:
        return sum(c.wire_bytes for c in self.collectives.values())

    @property
    def collective_operand_bytes(self) -> float:
        return sum(c.operand_bytes for c in self.collectives.values())

    @property
    def total_instructions(self) -> float:
        """Eq. 1 analogue: issue-scaled instructions + scalar ones."""
        return self.tc_issues + self.warp_issues + self.scalar_ops

    def merge_scaled(self, other: "Census", mult: float) -> None:
        for f in ("flops", "tc_flops", "tc_flops_f32", "warp_flops",
                  "hbm_bytes",
                  "layout_bytes", "irregular_bytes", "tc_issues",
                  "tc_flops_padded", "warp_issues", "scalar_ops",
                  "flop_counter_flops"):
            setattr(self, f, getattr(self, f) + getattr(other, f) * mult)
        for k, v in other.opcode_counts.items():
            self.opcode_counts[k] += v * mult
        for k, v in other.class_counts.items():
            self.class_counts[k] += v * mult
        for k, v in other.tc_op_flops.items():
            self.tc_op_flops[k] += v * mult
        for kind, stat in other.collectives.items():
            dst = self.collectives.setdefault(kind, CollectiveStat(kind))
            dst.count += stat.count * mult
            dst.operand_bytes += stat.operand_bytes * mult
            dst.wire_bytes += stat.wire_bytes * mult


# ---------------------------------------------------------------------------
# per-op rules
# ---------------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    """Bytes an op reads or writes of ``t``: its elements, at most its
    storage (an expanded input is read once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _is_index(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex)


def tc_issues(func, args, flops: float) -> float:
    """m16n8k16 issues of one tensor-core op, ceil-tiled for the GEMMs."""
    name = func._overloadpacket.__name__
    if name in ("mm", "addmm", "_scaled_mm"):
        a, b = (args[1], args[2]) if name == "addmm" else (args[0], args[1])
        (M, K), N, batch = a.shape, b.shape[1], 1
    elif name in ("bmm", "baddbmm"):
        a, b = (args[1], args[2]) if name == "baddbmm" else (args[0], args[1])
        (batch, M, K), N = a.shape, b.shape[2]
    else:
        return float(math.ceil(flops / FLOPS_PER_MMA))
    return float(batch * math.ceil(M / MMA_M) * math.ceil(N / MMA_N)
                 * math.ceil(K / MMA_K))


def _group_size(func, args, kwargs) -> int:
    names = [a.name for a in func._schema.arguments]
    bound = dict(zip(names, args), **kwargs)
    if bound.get("group_size"):
        return int(bound["group_size"])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(bound["group_name"]).size()


class _Counter:
    """The per-op rules applied to a ``Census``."""

    def __init__(self, census: Census):
        self.c = census
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry

    def count(self, func, args, kwargs, out) -> None:
        c = self.c
        packet = func._overloadpacket
        name = packet.__name__
        ns = func.namespace
        if ns == "prim":                          # metadata, not an op
            return
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_b = sum(nbytes(t) for t in ins)
        out_b = sum(nbytes(t) for t in outs)
        out_el = sum(t.numel() for t in outs)
        if func.is_view or name in _FREE:
            cls = "free"
        elif ns in _COLLECTIVE_NS:
            cls = "collective"
            kind = _COLLECTIVE_KIND.get(name, name)
            g = _group_size(func, args, kwargs)
            stat = c.collectives.setdefault(kind, CollectiveStat(kind))
            stat.count += 1
            if kind == "all-gather":
                payload, wire = out_b, out_b * (g - 1) / g
            elif kind == "all-reduce":
                payload, wire = out_b, 2.0 * out_b * (g - 1) / g
            elif kind in ("reduce-scatter", "all-to-all"):
                payload, wire = in_b, in_b * (g - 1) / g
            else:
                payload = wire = out_b
            stat.operand_bytes += payload
            stat.wire_bytes += wire
            c.hbm_bytes += in_b + out_b
        elif packet in self.registry:
            cls = "tc"
            flops = float(self.registry[packet](*args, **kwargs,
                                                out_val=out))
            issues = tc_issues(func, args, flops)
            c.tc_flops += flops
            if outs and outs[0].dtype in (torch.float32, torch.float64):
                c.tc_flops_f32 += flops
            c.flops += flops
            c.tc_issues += issues
            c.tc_flops_padded += issues * FLOPS_PER_MMA
            c.tc_op_flops[(f"{ns}.{name}", int(flops))] += 1
            c.hbm_bytes += in_b + out_b
        elif name in _FILL:
            cls = "fill"
            c.hbm_bytes += out_b
            c.warp_issues += math.ceil(out_el / WARP_LANES)
        elif outs and all(t.dim() == 0 for t in outs):
            cls = "scalar"
            c.scalar_ops += 1
            c.hbm_bytes += in_b + out_b
        elif name in _LAYOUT:
            cls = "layout"
            moved = (nbytes(args[1]) + out_b if name == "copy_"
                     else in_b + out_b)
            c.layout_bytes += moved
            c.hbm_bytes += moved
            c.warp_issues += math.ceil(out_el / WARP_LANES)
        elif name in _GATHER or name in _SCATTER:
            cls = "irregular"
            idx = sum(nbytes(t) for t in ins if _is_index(t))
            if name in _GATHER:
                moved, el = 2.0 * out_b + idx, out_el
            elif name.endswith("_") and len(ins) > 1:
                upd = [t for t in ins[1:] if not _is_index(t)]
                el = sum(t.numel() for t in upd)
                moved = 2.0 * sum(nbytes(t) for t in upd) + idx
            else:
                moved, el = in_b + out_b, out_el
            c.irregular_bytes += moved
            c.hbm_bytes += moved
            c.warp_flops += el
            c.flops += el
            c.warp_issues += math.ceil(el / WARP_LANES)
        else:
            cls = "warp"
            el = max([out_el] + [t.numel() for t in ins])
            c.warp_flops += el
            c.flops += el
            c.warp_issues += math.ceil(el / WARP_LANES)
            c.hbm_bytes += in_b + out_b
        c.opcode_counts[f"{ns}.{name}"] += 1
        c.class_counts[cls] += 1


class _LiveBytes:
    """Bytes of the storages alive in the trace, and their peak."""

    def __init__(self, census: Census):
        self.c = census
        self.live: Dict[int, int] = {}
        self.now = 0

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def add(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            try:
                s = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = id(s)
            if key in self.live:
                continue
            self.live[key] = s.nbytes()
            self.now += s.nbytes()
            weakref.finalize(s, self._free, key)
        self.c.peak_live_bytes = float(max(self.c.peak_live_bytes, self.now))


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


@contextlib.contextmanager
def local_shards_only():
    """DTensor's shape propagation with every dispatch mode off (see the
    module doc); refuses a torch whose propagator lacks the method."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:
        raise RuntimeError(
            f"torch {torch.__version__}: ShardingPropagator has no {name}; "
            f"the census cannot keep DTensor's global-shape propagation "
            f"ops out of its per-device counts")

    def quiet(self, *a, **k):
        with _disable_current_modes():
            return orig(self, *a, **k)

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _mode_class():
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class CensusMode(TorchDispatchMode):
        """Counts each op on plain (fake) tensors; hands DTensor ops
        back so that their local ops are seen instead."""

        def __init__(self, counter: _Counter, live: _LiveBytes):
            super().__init__()
            self.counter, self.live = counter, live

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            self.counter.count(func, args, kwargs, out)
            self.live.add(_tensors(out))
            return out

    return CensusMode


def _fake_mode(args):
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_leaves
    mode = detect_fake_mode([_local(t) for t in tree_leaves(args)
                             if isinstance(t, torch.Tensor)])
    return mode or FakeTensorMode()


def census_of_step(fn, *args, **kwargs) -> Census:
    """Run ``fn(*args, **kwargs)`` once on fake tensors and count what
    one device does (see the module doc).  The arguments are fake
    tensors or DTensors over fake local shards (a real tensor among them
    is taken into the fake mode first, by its shape); the output is
    dropped after its local bytes are read."""
    from torch.utils._pytree import tree_map
    from torch.utils.flop_counter import FlopCounterMode
    census = Census()
    mode = _fake_mode((args, kwargs))

    def fake(x):
        if isinstance(x, torch.Tensor) and not isinstance(
                _local(x), torch._subclasses.fake_tensor.FakeTensor):
            return mode.from_tensor(x)
        return x

    args, kwargs = tree_map(fake, (args, kwargs))
    live = _LiveBytes(census)
    arg_storages = {}
    for t in _tensors((args, kwargs)):
        s = _local(t).untyped_storage()
        arg_storages[id(s)] = s.nbytes()
    census.argument_bytes = float(sum(arg_storages.values()))
    live.add(_local(t) for t in _tensors((args, kwargs)))
    flop_counter = FlopCounterMode(display=False)
    with local_shards_only(), mode, flop_counter, \
            _mode_class()(_Counter(census), live):
        out = fn(*args, **kwargs)
    census.output_bytes = float(sum(
        nbytes(_local(t)) for t in _tensors(out)))
    census.flop_counter_flops = float(flop_counter.get_total_flops())
    return census
