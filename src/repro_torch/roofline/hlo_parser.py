"""Post-optimization HLO text analyzer with while-loop trip-count folding.

XLA's HloCostAnalysis (what ``compiled.cost_analysis()`` reports) visits a
while body ONCE, so anything inside a scan — i.e. every layer of a
scan-over-layers model — is undercounted by the trip count.  This module
re-derives the three roofline numerators from ``compiled.as_text()``:

  * flops            — 2*M*N*K for every dot (from operand shapes +
                       contracting dims), multiplied up the while-loop
                       nesting chain;
  * bytes accessed   — sum of operand + result shape bytes per op
                       (the same approximation HloCostAnalysis uses);
  * collective bytes — result-shape bytes of all-gather / all-reduce /
                       reduce-scatter / all-to-all / collective-permute.

Trip counts are parsed from each while's condition computation (the
`compare(..., constant(N))` bound).  Nested loops multiply.  This is the
"profile" the §Perf iteration loop reads, since there is no real TPU to
trace on.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s2": 1, "u2": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
}

_SHAPE_RE = re.compile(r"\b([a-z]+[0-9]+(?:e[0-9a-z]+)?|pred)\[([0-9,]*)\]")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all")


def cost_analysis_dict(compiled) -> Dict[str, float]:
    """``compiled.cost_analysis()`` as a flat dict across jaxlib versions.

    Older jaxlibs return a list with one dict per partition (we sum across
    them — "flops" etc. are per-executable totals); newer ones return the
    dict directly; either may be None/empty for trivial programs.
    """
    try:
        cost = compiled.cost_analysis()
    except Exception:
        return {}
    if cost is None:
        return {}
    if isinstance(cost, (list, tuple)):
        merged: Dict[str, float] = {}
        for part in cost:
            for k, v in dict(part).items():
                if isinstance(v, (int, float)):
                    merged[k] = merged.get(k, 0.0) + float(v)
                else:
                    merged.setdefault(k, v)
        return merged
    return dict(cost)


def _shape_elems_bytes(dt: str, dims: str) -> Tuple[int, int]:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n, n * _DTYPE_BYTES.get(dt, 4)


def _all_shape_bytes(text: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(text):
        _, b = _shape_elems_bytes(m.group(1), m.group(2))
        total += b
    return total


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes: float = 0.0
    excluded_bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in _COLLECTIVES})
    calls: List[Tuple[str, float, bool]] = dataclasses.field(
        default_factory=list)
    # (callee computation, multiplier, count_bytes_inside)


def _dot_flops(result_elems: int, lhs_dims: List[int], line: str) -> float:
    """2 * prod(result dims) * prod(lhs contracting dims)."""
    mc = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", line)
    contract = 1
    if mc and mc.group(1):
        for idx in mc.group(1).split(","):
            i = int(idx)
            if i < len(lhs_dims):
                contract *= lhs_dims[i]
    return 2.0 * result_elems * contract


def _trip_count(cond_body: List[str]) -> int:
    """Largest integer constant in the condition computation (the loop
    bound for canonical 0..N counters); 1 if none found."""
    best = 1
    for line in cond_body:
        for m in re.finditer(r"constant\((\d+)\)", line):
            best = max(best, int(m.group(1)))
    return best


def parse_computations(hlo_text: str) -> Dict[str, List[str]]:
    """computation name -> list of op lines."""
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    for raw in hlo_text.splitlines():
        line = raw.rstrip()
        s = line.strip()
        # computation header: `%name (params...) -> type {` (nested parens
        # possible in tuple-typed params), optionally `ENTRY`-prefixed
        m = re.match(r"(?:ENTRY\s+)?%([\w.\-]+)\s*\(.*\{\s*$", s)
        if m and "= " not in s.split("(")[0]:
            cur = m.group(1)
            comps[cur] = []
            continue
        if s == "}" or s.startswith("} //"):
            cur = None
            continue
        if cur is not None and s:
            comps[cur].append(s)
    return comps


def _entry_name(hlo_text: str, comps: Dict[str, List[str]]) -> Optional[str]:
    m = re.search(r"ENTRY\s+%?([\w.\-]+)", hlo_text)
    if m and m.group(1) in comps:
        return m.group(1)
    return next(iter(comps)) if comps else None


def _op_name(rhs: str) -> Optional[str]:
    m = re.search(r"\s([a-z][a-z0-9\-]*)\(", rhs)
    return m.group(1) if m else None


def _fusion_operand_bytes(rhs, op, callees, comps, symtab) -> int:
    """Operand traffic of a fusion: a parameter consumed ONLY by
    dynamic-slice inside the fusion is read at slice size, not full size
    (the layer-scan weight access pattern)."""
    names = _operand_names(rhs, op)
    full = [_shape_list_bytes(symtab.get(nm, [])) for nm in names]
    if not callees or not names:
        return sum(full)
    lines = comps.get(callees[0], [])
    # param index -> name, and dynamic-slice consumers
    params = {}
    for s in lines:
        m = re.match(r"%?([\w.\-]+)\s*=\s*.*parameter\((\d+)\)", s)
        if m:
            params[m.group(1)] = int(m.group(2))
    sliced_bytes: Dict[int, int] = {}
    non_slice_use: set = set()
    for s in lines:
        m = _LINE_RE.match(s)
        if not m:
            continue
        irhs = _split_meta(m.group(2))
        iop = _op_name(irhs)
        if iop in (None, "parameter"):
            continue
        operands = _operand_names(irhs, iop)
        rsh = _result_shapes(irhs, iop)
        for onm in operands:
            if onm in params:
                idx = params[onm]
                if iop == "dynamic-slice":
                    sliced_bytes[idx] = (sliced_bytes.get(idx, 0)
                                         + _shape_list_bytes(rsh))
                else:
                    non_slice_use.add(idx)
    total = 0
    for i, fb in enumerate(full):
        if i in sliced_bytes and i not in non_slice_use:
            total += min(fb, sliced_bytes[i])
        else:
            total += fb
    return total


_LINE_RE = re.compile(r"^(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.+)$")

_CAST_OPS = {"parameter", "convert", "bitcast", "reshape", "copy",
             "reduce-precision", "constant", "broadcast",
             "get-tuple-element", "tuple"}


def _inplace_update_bytes(lines: List[str]) -> Optional[int]:
    """If the fusion is a slice-update (root = dynamic-update-slice chain),
    return 2x the update bytes (read update + write slice) — XLA updates
    the buffer in place; the full-buffer boundary shapes are not traffic.
    Returns None when the fusion is not an update pattern."""
    symtab = {}
    dus_updates = 0
    root_is_dus = False
    for s in lines:
        m = _LINE_RE.match(s)
        if not m:
            continue
        rhs = _split_meta(m.group(2))
        op = _op_name(rhs)
        rsh = _result_shapes(rhs, op)
        symtab[m.group(1)] = rsh
        if op == "dynamic-update-slice":
            ops_n = _operand_names(rhs, op)
            if len(ops_n) > 1:
                dus_updates += _shape_list_bytes(symtab.get(ops_n[1], []))
            if s.lstrip().startswith("ROOT"):
                root_is_dus = True
        elif s.lstrip().startswith("ROOT") and op in ("bitcast", "copy",
                                                      "tuple"):
            root_is_dus = root_is_dus or dus_updates > 0
    if dus_updates and root_is_dus:
        return 2 * dus_updates
    return None


def _pure_cast_fusion(lines: List[str]) -> bool:
    """True when a fusion body only recasts/reshapes its inputs — such a
    fusion materializes a dtype copy the CPU backend hoists out of loops;
    a TPU compilation computes in native bf16 and never creates it."""
    for s in lines:
        m = _LINE_RE.match(s)
        if not m:
            continue
        op = _op_name(_split_meta(m.group(2)))
        if op is not None and op not in _CAST_OPS:
            return False
    return True


def _split_meta(rhs: str) -> str:
    """Strip metadata / control-deps so operand scans don't see them."""
    for marker in (", metadata=", ", control-predecessors=",
                   ", backend_config=", ", sharding="):
        idx = rhs.find(marker)
        if idx >= 0:
            rhs = rhs[:idx]
    return rhs


def _result_shapes(rhs: str, op: Optional[str]):
    """Shapes appearing before the op name = the result type."""
    cut = rhs
    if op:
        idx = rhs.find(f" {op}(")
        if idx >= 0:
            cut = rhs[:idx]
    return _SHAPE_RE.findall(cut)


def _operand_names(rhs: str, op: Optional[str]) -> List[str]:
    if not op:
        return []
    idx = rhs.find(f" {op}(")
    if idx < 0:
        return []
    body = rhs[idx + len(op) + 2:]
    depth = 1
    out_chars = []
    for ch in body:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                break
        out_chars.append(ch)
    return re.findall(r"%([\w.\-]+)", "".join(out_chars))


def _shape_list_bytes(shapes) -> int:
    return sum(_shape_elems_bytes(dt, dims)[1] for dt, dims in shapes)


def _comp_stats(lines: List[str], comps: Dict[str, List[str]],
                exclude_scope: Optional[str] = None) -> OpStats:
    """exclude_scope: ops whose metadata op_name contains this substring
    contribute NO bytes (they live in VMEM inside a Pallas kernel on the
    real hardware); their flops still count.  Excluded bytes are recorded
    in st.excluded_bytes so the caller can report the adjustment."""
    st = OpStats()
    # first pass: symbol table name -> result shapes
    symtab: Dict[str, List[Tuple[str, str]]] = {}
    parsed = []
    for s in lines:
        m = _LINE_RE.match(s)
        if not m:
            continue
        raw = m.group(2)
        name, rhs = m.group(1), _split_meta(raw)
        op = _op_name(rhs)
        rshapes = _result_shapes(rhs, op)
        symtab[name] = rshapes
        parsed.append((name, rhs, op, rshapes, raw))

    def operand_bytes(rhs, op):
        return sum(_shape_list_bytes(symtab.get(nm, []))
                   for nm in _operand_names(rhs, op))

    def add_bytes(n, in_scope):
        if in_scope:
            st.excluded_bytes += n
        else:
            st.bytes += n

    for name, rhs, op, rshapes, raw_rhs in parsed:
        if op is None:
            continue
        in_scope = False
        if exclude_scope and 'op_name="' in raw_rhs:
            op_path = raw_rhs.split('op_name="', 1)[1].split('"')[0]
            scopes = ((exclude_scope,) if isinstance(exclude_scope, str)
                      else exclude_scope)
            in_scope = any(sc in op_path for sc in scopes)
        if op in ("parameter", "constant", "get-tuple-element", "tuple",
                  "bitcast", "after-all", "partition-id", "replica-id",
                  "iota", "copy-start", "copy-done",
                  # free under producer/consumer fusion on TPU: pure
                  # recasts/reshapes (the CPU backend materializes bf16->f32
                  # converts it hoists out of loops; a TPU compilation
                  # computes in native bf16 and fuses the rest)
                  "convert", "reduce-precision", "reshape"):
            continue
        if op == "while":
            mb = re.search(r"body=%?([\w.\-]+)", rhs)
            mc = re.search(r"condition=%?([\w.\-]+)", rhs)
            # prefer XLA's own annotation when present
            mt = re.search(r'known_trip_count[^0-9]*"n":"(\d+)"', raw_rhs)
            if mt:
                trip = int(mt.group(1))
            else:
                trip = _trip_count(comps.get(mc.group(1), [])) if mc else 1
            if mb:
                # loop body: bytes inside are real per-iteration traffic
                st.calls.append((mb.group(1), float(trip), True))
            continue
        base = op.replace("-start", "").replace("-done", "")
        if base in _COLLECTIVES:
            if not op.endswith("-done") and rshapes:
                # wire-cost weights (ring algorithms, large-N limit):
                # all-reduce moves 2x its payload (reduce-scatter phase +
                # all-gather phase); the others move ~1x their result.
                # all-reduce results may be tuples (fused gradient
                # reductions) — count every element.
                weight = 2.0 if base == "all-reduce" else 1.0
                st.coll_bytes[base] += weight * _shape_list_bytes(rshapes)
            continue
        if op == "scatter":
            ops_n = _operand_names(rhs, op)
            upd = (_shape_list_bytes(symtab.get(ops_n[-1], []))
                   if ops_n else 0)
            add_bytes(2 * upd, in_scope)   # in-place: read+write updates only
            continue
        if op in ("fusion", "call", "custom-call", "conditional",
                  "async-start", "map", "reduce", "sort",
                  "select-and-scatter", "reduce-window"):
            callees = [mcall.group(1) for mcall in re.finditer(
                r"(?:calls|to_apply|called_computations|branch_"
                r"computations)=\{?%?([\w.\-]+)", rhs)]
            for cal in callees:
                # fusion interior: count flops (dots fuse) but not bytes —
                # the fusion boundary (this op line) carries the traffic
                st.calls.append((cal, 1.0, False))
            if (op == "fusion" and callees
                    and _pure_cast_fusion(comps.get(callees[0], []))):
                continue   # dtype-copy fusion: free on TPU (see above)
            if op == "fusion" and callees:
                upd = _inplace_update_bytes(comps.get(callees[0], []))
                if upd is not None:
                    add_bytes(upd, in_scope)
                    continue
            ob = _fusion_operand_bytes(rhs, op, callees, comps, symtab)
            add_bytes(_shape_list_bytes(rshapes) + ob, in_scope)
            continue
        if op in ("dot", "convolution"):
            res_elems = sum(_shape_elems_bytes(dt, d)[0]
                            for dt, d in rshapes)
            ops = _operand_names(rhs, op)
            lhs_dims: List[int] = []
            if ops:
                lhs_shapes = symtab.get(ops[0], [])
                if lhs_shapes:
                    lhs_dims = [int(d) for d in lhs_shapes[0][1].split(",")
                                if d]
            st.flops += _dot_flops(res_elems, lhs_dims, rhs)
        # idealized-fusion byte model: every intermediate is written once
        # (result bytes here); operand reads are charged only at
        # materialization points (dot/copy ops), emulating the
        # producer->consumer fusion a TPU compilation would perform.
        # In-place/windowed ops are charged at their TOUCHED size:
        #   dynamic-slice / gather: the slice (result), read + written;
        #   dynamic-update-slice:   the update operand, read + written
        #   (XLA updates in place; charging the full buffer would count a
        #   one-token KV-cache append as two full cache sweeps).
        if op in ("dynamic-slice", "gather"):
            add_bytes(2 * _shape_list_bytes(rshapes), in_scope)
            continue
        if op == "dynamic-update-slice":
            ops_n = _operand_names(rhs, op)
            upd = (_shape_list_bytes(symtab.get(ops_n[1], []))
                   if len(ops_n) > 1 else 0)
            add_bytes(2 * upd, in_scope)
            continue
        add_bytes(_shape_list_bytes(rshapes), in_scope)
        if op in ("dot", "convolution", "copy", "transpose", "concatenate"):
            add_bytes(operand_bytes(rhs, op), in_scope)
    return st


def analyze(hlo_text: str, exclude_scope: Optional[str] = None) -> Dict:
    """Trip-count-corrected {flops, bytes, collectives{...}} totals.

    exclude_scope: byte traffic of ops under this jax.named_scope (matched
    against HLO metadata op_name) is moved to "excluded_bytes" — used to
    model Pallas-kernel VMEM residency (e.g. "flash_attention": the score
    tensors never touch HBM on the real hardware)."""
    comps = parse_computations(hlo_text)
    stats = {name: _comp_stats(lines, comps, exclude_scope)
             for name, lines in comps.items()}
    entry = _entry_name(hlo_text, comps)
    totals = OpStats()
    visiting = set()

    def accumulate(name: str, mult: float, count_bytes: bool):
        if name not in stats or name in visiting:
            return
        visiting.add(name)
        st = stats[name]
        totals.flops += st.flops * mult
        if count_bytes:
            totals.bytes += st.bytes * mult
            totals.excluded_bytes += st.excluded_bytes * mult
        for callee, m, cb in st.calls:
            accumulate(callee, mult * m, count_bytes and cb)
        for k, v in st.coll_bytes.items():
            totals.coll_bytes[k] += v * mult
        visiting.discard(name)

    if entry:
        accumulate(entry, 1.0, True)
    return {
        "flops": totals.flops,
        "bytes": totals.bytes,
        "excluded_bytes": totals.excluded_bytes,
        "collectives": {k: v for k, v in totals.coll_bytes.items()},
        "collective_bytes": sum(totals.coll_bytes.values()),
    }
