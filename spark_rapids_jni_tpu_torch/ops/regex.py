"""Regex tier, cudf's strings/regex surface (port of the JAX package's
``ops/regex.py``).

The reference offloads Spark's RLIKE / regexp_extract / split /
regexp_replace to cudf's backtracking regex VM. This engine is compiled
and table-driven instead, as the JAX package's is:

  host (per pattern, cached):
    parse a regex SUBSET -> Thompson NFA -> subset-construction DFA over
    codepoint *equivalence classes* (every class boundary in the pattern
    splits [0, 0x110000) into a handful of intervals; a 0x110000-entry
    int32 lookup maps codepoint -> class id). The host compiler is a copy
    of the reference's, so the tables are the same.
  device (per batch):
    strings decode to a padded [N, L] int32 codepoint matrix
    (``ops/utf8.py``), and the DFA steps over the L columns in a Python
    loop, one [n_states * n_classes] table lookup per step for every row
    at once (the reference's ``lax.scan``).

Three runtimes ride the same machinery:
  - ``matches_re`` / ``contains_re``: one DFA run, O(N*L). Unanchored
    search compiles the ".*pattern" DFA, so ``contains`` is one run too.
  - span finding (extract / split): an ALL-STARTS run; state column p
    tracks the run anchored at codepoint p, so one pass gives every
    (start, end) match pair. O(N*L^2) work; step j touches only the
    j + 1 start positions that can be active.
  - leftmost-greedy capture groups: the pattern's top-level
    concatenation is split into segments; a backward pass computes
    suffix-matchability sets and a forward pass picks each segment's
    greedy (or lazy) end consistent with the suffix.

Subset: literals, '.', escapes, char classes (ranges, negation,
\\d \\D \\w \\W \\s \\S, all ASCII), concatenation, alternation, groups
(capturing / (?:...)), quantifiers * + ? {m} {m,} {m,n} with lazy '?'
variants, anchors ^ $ at the pattern edges. Unsupported (ValueError):
backreferences, lookaround, word boundaries, inline flags; nested or
quantified capture groups cannot be extracted. Alternation is matched
longest-wins (DFA semantics), not PCRE-ordered, as in the reference.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..columnar import Column
from ..columnar import dtype as dt
from ..columnar.dtype import TypeId
from . import strings
from .utf8 import MAX_CODEPOINT, decode_padded
from ..utils.dispatch import op_boundary

__all__ = [
    "compile_pattern",
    "contains_re",
    "matches_re",
    "extract_re",
    "split_re",
    "replace_re",
]

_NCP = MAX_CODEPOINT + 1
_MAX_DFA_STATES = 1024
_MAX_REP = 64

# ---------------------------------------------------------------------------
# Parser: pattern -> AST
# AST nodes (plain tuples):
#   ("class", ((lo, hi), ...))       inclusive codepoint intervals
#   ("cat", (child, ...))
#   ("alt", (child, ...))
#   ("rep", child, m, n, greedy)     n=None means unbounded
#   ("group", index, child)          capturing group, 1-based index
# ---------------------------------------------------------------------------

_D = ((ord("0"), ord("9")),)
_W = ((ord("0"), ord("9")), (ord("A"), ord("Z")), (ord("_"), ord("_")), (ord("a"), ord("z")))
_S = tuple(sorted((ord(c), ord(c)) for c in " \t\n\r\f\v"))


def _negate(intervals) -> Tuple[Tuple[int, int], ...]:
    out, prev = [], 0
    for lo, hi in sorted(intervals):
        if lo > prev:
            out.append((prev, lo - 1))
        prev = max(prev, hi + 1)
    if prev <= MAX_CODEPOINT:
        out.append((prev, MAX_CODEPOINT))
    return tuple(out)


_DOT = _negate(((ord("\n"), ord("\n")),))  # '.' = any char except \n (no DOTALL)
_ANY = ((0, MAX_CODEPOINT),)

_ESCAPE_CLASSES = {
    "d": _D,
    "D": _negate(_D),
    "w": _W,
    "W": _negate(_W),
    "s": _S,
    "S": _negate(_S),
}
_ESCAPE_LITERALS = {
    "n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
    "0": "\0", "a": "\a", "b": "\b", "e": "\x1b",
}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.ngroups = 0
        self.anchor_start = False
        self.anchor_end = False

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        if self.i >= len(self.p):
            raise ValueError(f"unexpected end of pattern /{self.p}/")
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        if self.peek() == "^":
            self.take()
            self.anchor_start = True
        ast = self.alt()
        if self.i < len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i} in /{self.p}/")
        if (self.anchor_start or self.anchor_end) and ast[0] == "alt":
            # flags anchor the WHOLE pattern; with a top-level alternation
            # Java scopes them to one branch — refuse rather than silently
            # anchoring every branch (group the alternation to anchor all)
            raise ValueError(
                "anchors with top-level alternation unsupported — "
                "group the alternation: ^(?:a|b)$"
            )
        return ast

    def alt(self):
        branches = [self.cat()]
        while self.peek() == "|":
            self.take()
            branches.append(self.cat())
        return branches[0] if len(branches) == 1 else ("alt", tuple(branches))

    def cat(self):
        items: list = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            if c == "$":
                if self.i == len(self.p) - 1:
                    self.take()
                    self.anchor_end = True
                    break
                raise ValueError("'$' supported only at pattern end")
            if c == "^":
                raise ValueError("'^' supported only at pattern start")
            items.append(self.quantified())
        return ("cat", tuple(items))

    def quantified(self):
        atom = self.atom()
        c = self.peek()
        if c in ("*", "+", "?"):
            self.take()
            m, n = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
        elif c == "{":
            m, n = self.brace()
        else:
            return atom
        greedy = True
        if self.peek() == "?":
            self.take()
            greedy = False
        if _contains_group(atom) and (m, n) != (1, 1):
            # a quantified capture group's spans can't be recovered by
            # the segment decomposition; matching still works with the
            # group markers dropped (extract of that index will raise)
            atom = _strip_groups(atom)
        return ("rep", atom, m, n, greedy)

    def brace(self):
        self.take()  # '{'
        start = self.i
        while self.peek() is not None and self.peek() != "}":
            self.take()
        if self.peek() != "}":
            raise ValueError("unterminated {…} quantifier")
        body = self.p[start : self.i]
        self.take()
        parts = body.split(",")
        try:
            if len(parts) == 1:
                m = n = int(parts[0])
            elif len(parts) == 2:
                m = int(parts[0])
                n = int(parts[1]) if parts[1] else None
            else:
                raise ValueError
        except ValueError:
            raise ValueError(f"bad quantifier {{{body}}}") from None
        if m < 0 or m > _MAX_REP or (n is not None and (n > _MAX_REP or n < m)):
            raise ValueError(f"repetition bounds out of [0, {_MAX_REP}] (or n<m) in {{{body}}}")
        return m, n

    def atom(self):
        c = self.take()
        if c == "(":
            capturing = True
            if self.peek() == "?":
                self.take()
                nxt = self.take()
                if nxt == ":":
                    capturing = False
                else:
                    raise ValueError(f"unsupported group (?{nxt}…) — only (?:…)")
            if capturing:
                self.ngroups += 1
                idx = self.ngroups
            inner = self.alt()
            if self.peek() != ")":
                raise ValueError("unbalanced '('")
            self.take()
            return ("group", idx, inner) if capturing else inner
        if c == "[":
            return self.char_class()
        if c == ".":
            return ("class", _DOT)
        if c == "\\":
            return self.escape(in_class=False)
        if c in "*+?{":
            raise ValueError(f"dangling quantifier {c!r}")
        return ("class", ((ord(c), ord(c)),))

    def escape(self, in_class: bool):
        if self.peek() is None:
            raise ValueError("trailing backslash")
        e = self.take()
        if e in _ESCAPE_CLASSES:
            ivs = _ESCAPE_CLASSES[e]
            return ivs if in_class else ("class", tuple(ivs))
        # \b is backspace inside a class, word boundary (unsupported) outside
        if e in _ESCAPE_LITERALS and (in_class or e != "b"):
            ch = _ESCAPE_LITERALS[e]
            iv = ((ord(ch), ord(ch)),)
            return iv if in_class else ("class", iv)
        if e == "x":
            h = self.take() + self.take()
            iv = ((int(h, 16), int(h, 16)),)
            return iv if in_class else ("class", iv)
        if e == "u":
            h = "".join(self.take() for _ in range(4))
            iv = ((int(h, 16), int(h, 16)),)
            return iv if in_class else ("class", iv)
        if e.isalnum():
            raise ValueError(f"unsupported escape \\{e}")
        iv = ((ord(e), ord(e)),)
        return iv if in_class else ("class", iv)

    def char_class(self):
        negated = False
        if self.peek() == "^":
            self.take()
            negated = True
        intervals: list = []
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise ValueError("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            self.take()
            if c == "\\":
                ivs = self.escape(in_class=True)
                if len(ivs) > 1 or ivs[0][0] != ivs[0][1]:
                    intervals.extend(ivs)
                    continue
                lo = ivs[0][0]
            else:
                lo = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.take()
                hc = self.take()
                if hc == "\\":
                    ivs = self.escape(in_class=True)
                    if len(ivs) != 1 or ivs[0][0] != ivs[0][1]:
                        raise ValueError("bad range end in character class")
                    hi = ivs[0][0]
                else:
                    hi = ord(hc)
                if hi < lo:
                    raise ValueError("reversed range in character class")
                intervals.append((lo, hi))
            else:
                intervals.append((lo, lo))
        ivs = tuple(sorted(intervals))
        return ("class", _negate(ivs) if negated else ivs)


def _contains_group(ast) -> bool:
    if ast[0] == "group":
        return True
    if ast[0] in ("cat", "alt"):
        return any(_contains_group(c) for c in ast[1])
    if ast[0] == "rep":
        return _contains_group(ast[1])
    return False


def _strip_groups(ast):
    if ast[0] == "group":
        return _strip_groups(ast[2])
    if ast[0] in ("cat", "alt"):
        return (ast[0], tuple(_strip_groups(c) for c in ast[1]))
    if ast[0] == "rep":
        return ("rep", _strip_groups(ast[1]), *ast[2:])
    return ast


# ---------------------------------------------------------------------------
# NFA (Thompson) -> DFA (subset construction over equivalence classes)
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[Tuple[Tuple[int, int], ...], int]]] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add(self, ast) -> Tuple[int, int]:
        kind = ast[0]
        if kind == "class":
            s, t = self.new_state(), self.new_state()
            self.trans[s].append((ast[1], t))
            return s, t
        if kind == "group":
            return self.add(ast[2])
        if kind == "cat":
            s = t = self.new_state()
            for child in ast[1]:
                cs, ct = self.add(child)
                self.eps[t].append(cs)
                t = ct
            return s, t
        if kind == "alt":
            s, t = self.new_state(), self.new_state()
            for child in ast[1]:
                cs, ct = self.add(child)
                self.eps[s].append(cs)
                self.eps[ct].append(t)
            return s, t
        if kind == "rep":
            _, child, m, n, _greedy = ast
            s = t = self.new_state()
            for _ in range(m):
                cs, ct = self.add(child)
                self.eps[t].append(cs)
                t = ct
            if n is None:
                cs, ct = self.add(child)
                end = self.new_state()
                self.eps[t].append(cs)
                self.eps[ct].append(cs)
                self.eps[t].append(end)
                self.eps[ct].append(end)
                return s, end
            tails = [t]
            for _ in range(n - m):
                cs, ct = self.add(child)
                self.eps[t].append(cs)
                t = ct
                tails.append(t)
            end = self.new_state()
            for x in tails:
                self.eps[x].append(end)
            return s, end
        raise AssertionError(f"unknown AST node {kind}")

    def closure(self, states) -> frozenset:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for t in self.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)




class CompiledPattern:
    """Host-side compiled DFA + device tables, uploaded once per device."""

    def __init__(self, pattern, trans, accept, class_of, anchor_start,
                 anchor_end, ast, ngroups):
        self.pattern = pattern
        self.trans = trans          # np [S, C] int32
        self.accept = accept        # np [S] bool
        self.class_of = class_of    # np [_NCP] int32
        self.anchor_start = anchor_start
        self.anchor_end = anchor_end
        self.ast = ast
        self.ngroups = ngroups
        self._device: dict = {}

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    @property
    def n_classes(self) -> int:
        return self.trans.shape[1]

    def device_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(trans [(S+1) * (C+2)] int32, accept [S+1] bool, class_of [_NCP]
        int32) on ``device``: the DFA with two classes for the positions
        past a string's end, ``C`` (every state stays) and ``C + 1`` (every
        state goes to the dead state S, which never accepts and never
        leaves), so that the device runs need no per-step activity mask."""
        key = str(torch.device(device))
        if key not in self._device:
            S, C = self.trans.shape
            trans = np.full((S + 1, C + 2), S, np.int32)
            trans[:S, :C] = self.trans
            trans[:, C] = np.arange(S + 1)
            accept = np.append(self.accept, False)
            self._device[key] = tuple(torch.from_numpy(a).to(device) for a in (
                trans.reshape(-1), accept, np.ascontiguousarray(self.class_of)))
        return self._device[key]


def _compile_ast(ast, anchor_start=False, anchor_end=False, pattern="", ngroups=0) -> CompiledPattern:
    # 1) codepoint equivalence classes
    bounds = {0, _NCP}

    def walk(a):
        if a[0] == "class":
            for lo, hi in a[1]:
                bounds.add(lo)
                bounds.add(hi + 1)
        elif a[0] in ("cat", "alt"):
            for c in a[1]:
                walk(c)
        elif a[0] == "rep":
            walk(a[1])
        elif a[0] == "group":
            walk(a[2])

    walk(ast)
    cuts = sorted(b for b in bounds if 0 <= b <= _NCP)
    n_classes = len(cuts) - 1
    class_of = np.zeros(_NCP, np.int32)
    for ci in range(n_classes):
        class_of[cuts[ci] : cuts[ci + 1]] = ci
    reps = np.asarray(cuts[:-1], np.int64)  # representative cp per class

    # 2) NFA
    nfa = _NFA()
    start, accept_nfa = nfa.add(ast)

    def class_mask(intervals) -> np.ndarray:
        m = np.zeros(n_classes, bool)
        for lo, hi in intervals:
            m |= (reps >= lo) & (reps <= hi)
        return m

    trans_masks = [
        [(class_mask(ivs), t) for ivs, t in nfa.trans[s]] for s in range(len(nfa.trans))
    ]

    # 3) subset construction
    start_set = nfa.closure([start])
    ids = {start_set: 0}
    order = [start_set]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = np.zeros(n_classes, np.int32)
        for ci in range(n_classes):
            targets = set()
            for s in cur:
                for mask, t in trans_masks[s]:
                    if mask[ci]:
                        targets.add(t)
            nxt = nfa.closure(targets) if targets else frozenset()
            if nxt not in ids:
                if len(ids) >= _MAX_DFA_STATES:
                    raise ValueError(
                        f"pattern /{pattern}/ exceeds {_MAX_DFA_STATES} DFA states"
                    )
                ids[nxt] = len(ids)
                order.append(nxt)
            row[ci] = ids[nxt]
        rows.append(row)
        i += 1
    trans = np.stack(rows)
    accept = np.array([accept_nfa in st for st in order], bool)
    return CompiledPattern(pattern, trans, accept, class_of, anchor_start,
                           anchor_end, ast, ngroups)


@functools.lru_cache(maxsize=256)
def compile_pattern(pattern: str) -> CompiledPattern:
    """Parse + compile the ANCHORED pattern DFA (cached per process,
    like the plugin's cudf regex prog cache)."""
    p = _Parser(pattern)
    ast = p.parse()
    return _compile_ast(ast, p.anchor_start, p.anchor_end, pattern, p.ngroups)


@functools.lru_cache(maxsize=256)
def _search_pattern(pattern: str) -> CompiledPattern:
    """The ".*pattern" DFA for unanchored search: the subset
    construction absorbs the restart loop, so `contains` is a single
    forward run instead of an all-starts matrix."""
    p = _Parser(pattern)
    ast = _strip_groups(p.parse())
    if not p.anchor_start:
        ast = ("cat", (("rep", ("class", _ANY), 0, None, True), ast))
    return _compile_ast(ast, p.anchor_start, p.anchor_end, pattern, 0)



@functools.lru_cache(maxsize=256)
def _segment_program(ast, anchor_end: bool) -> CompiledPattern:
    """The anchored DFA of one top-level segment of an extract pattern
    (an AST of tuples, so it keys the cache itself)."""
    return _compile_ast(ast, anchor_end=anchor_end)


# ---------------------------------------------------------------------------
# Device runtimes
# ---------------------------------------------------------------------------


def _check_string(col: Column) -> None:
    if col.dtype.id != TypeId.STRING:
        raise ValueError("regex op on non-string column")


def _codepoints(col: Column):
    """(padded bytes, cp, cp_lens, byte_off) of a STRING column: one
    ``strings.to_padded`` and the UTF-8 decode."""
    padded, lens = strings.to_padded(col)
    cp, cp_lens, byte_off = decode_padded(padded, lens)
    return padded, cp, cp_lens, byte_off


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an int32 or int64 index of any shape."""
    return table.index_select(0, idx.reshape(-1)).view(idx.shape)


def _classes_t(prog: CompiledPattern, cp: torch.Tensor, cp_lens: torch.Tensor, end: int
               ) -> torch.Tensor:
    """[L, N] class ids, codepoint-major (a step reads one row): each
    codepoint's class, and class C + ``end`` past the row's end (see
    ``CompiledPattern.device_tables``)."""
    _, _, class_of = prog.device_tables(cp.device)
    cls = _lookup(class_of, cp.t().clamp(0, _NCP - 1))
    past = torch.arange(cp.shape[1], dtype=torch.int32, device=cp.device)[:, None] >= cp_lens
    return cls.masked_fill_(past, prog.n_classes + end)


def _forward_run(prog: CompiledPattern, cp, cp_lens, sticky: bool) -> torch.Tensor:
    """One DFA pass. sticky=False: accept[state after the full string]
    (full / suffix match). sticky=True: latch accept at any prefix
    position (substring search with a ".*"-prefixed DFA). Past its end a
    row's state stays as it is (class C), so the accept latched there
    adds nothing."""
    trans_flat, accept, _ = prog.device_tables(cp.device)
    n = cp.shape[0]
    cls_t = _classes_t(prog, cp, cp_lens, end=0)
    state = torch.zeros((n,), dtype=torch.int32, device=cp.device)
    hit = accept[0].expand(n).clone()
    for j in range(int(cp_lens.max()) if n else 0):  # later steps change no row
        state = _lookup(trans_flat, torch.add(cls_t[j], state, alpha=prog.n_classes + 2))
        if sticky:
            hit |= _lookup(accept, state)
    return hit if sticky else _lookup(accept, state)


def _all_starts(prog: CompiledPattern, cp, cp_lens, endmask, want: str):
    """All-starts DFA run over start positions p in [0, L]. Returns
    (matched [N, L+1], ends [N, L+1]): ``want`` "first" gives each start's
    first end, "last" its last end (codepoint indices, -1 where no
    mask-consistent accept was seen).

    endmask: optional [N, L+1] bool of permitted END positions; a '$'
    anchor additionally restricts ends to len.

    The runs are held start-major, [L+1, N], and the results returned as
    transposed views. Step j advances the runs that started at p <= j
    (the reference's ``parr <= j`` mask): the first j + 1 rows, a
    contiguous block updated in place. Past a row's end its runs go to
    the dead state (class C + 1), which never accepts.
    """
    trans_flat, accept, _ = prog.device_tables(cp.device)
    dev = cp.device
    n, L = cp.shape
    P = L + 1
    cls_t = _classes_t(prog, cp, cp_lens, end=1)
    lens = cp_lens[None, :]
    parr = torch.arange(P, dtype=torch.int32, device=dev)[:, None]

    em = None if endmask is None else endmask.t()
    if prog.anchor_end:
        anchor = parr == lens
        em = anchor if em is None else (em & anchor)
    matched = (parr <= lens) & bool(prog.accept[0])
    if em is not None:
        em = em.contiguous()
        matched &= em
    ends = torch.where(matched, parr, -1)
    S = torch.zeros((P, n), dtype=torch.int32, device=dev)
    stride = prog.n_classes + 2

    for j in range(int(cp_lens.max()) if n else 0):  # later steps change no run
        w = j + 1
        Sv = S[:w]
        torch.index_select(trans_flat, 0, torch.add(cls_t[j], Sv, alpha=stride).view(-1),
                           out=Sv.view(-1))
        acc = _lookup(accept, Sv)
        if em is not None:
            acc &= em[w]  # the end position j + 1 is permitted
        # a start's first end is its first accept
        ends[:w].masked_fill_(acc & ~matched[:w] if want == "first" else acc, w)
        matched[:w] |= acc
    return matched.t(), ends.t()


@op_boundary("strings.contains_re")
def contains_re(col: Column, pattern: str) -> Column:
    """Spark RLIKE: true iff the pattern matches anywhere in the string."""
    _check_string(col)
    prog = _search_pattern(pattern)
    _, cp, cp_lens, _ = _codepoints(col)
    # with a '$' anchor the sticky latch is wrong (the match must END at
    # len): the final state of the ".*pattern" run decides
    hit = _forward_run(prog, cp, cp_lens, sticky=not prog.anchor_end)
    return Column(dt.BOOL8, data=hit.to(torch.uint8), validity=col.validity)


@op_boundary("strings.matches_re")
def matches_re(col: Column, pattern: str) -> Column:
    """Full-string match (cudf matches_re; Spark LIKE-via-regex path)."""
    _check_string(col)
    prog = compile_pattern(pattern)
    _, cp, cp_lens, _ = _codepoints(col)
    ok = _forward_run(prog, cp, cp_lens, sticky=False)
    return Column(dt.BOOL8, data=ok.to(torch.uint8), validity=col.validity)


def _top_segments(prog: CompiledPattern):
    """Split the top-level concatenation into (ast, group_index_or_None)
    segments for span recovery."""
    ast = prog.ast
    items = ast[1] if ast[0] == "cat" else (ast,)
    segs = []
    for it in items:
        if it[0] == "group":
            if _contains_group(it[2]):
                raise ValueError("nested capture groups unsupported in extract")
            segs.append((it[2], it[1]))
        else:
            if _contains_group(it):
                raise ValueError(
                    "capture groups must be top-level concatenation members for extract"
                )
            segs.append((_strip_groups(it), None))
    return segs


def _gather1(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i]]`` for every row i, idx clipped to x's columns."""
    return torch.gather(x, 1, idx.to(torch.int64).clamp(0, x.shape[1] - 1)[:, None])[:, 0]


def _substr_by_cp_span(col: Column, padded, byte_off, begin_cp, end_cp, valid) -> Column:
    """Slice each row to the byte span of codepoints [begin, end);
    invalid rows become '' (validity handled by the caller)."""
    b0 = _gather1(byte_off, begin_cp)
    b1 = _gather1(byte_off, end_cp)
    out_lens = torch.where(valid, (b1 - b0).clamp(min=0), 0).to(torch.int32)
    return strings.from_padded(strings._take_cols(padded, b0, out_lens), out_lens, col.validity)


def _greedy(ast) -> bool:
    """A segment takes its last consistent end, unless it is a lazy
    repetition (then its first)."""
    while ast[0] == "cat" and len(ast[1]) == 1:  # unwrap 1-item groups
        ast = ast[1][0]
    return not (ast[0] == "rep" and ast[4] is False)


@op_boundary("strings.extract_re")
def extract_re(col: Column, pattern: str, group: int = 1) -> Column:
    """Spark regexp_extract(col, pattern, group): the capture group's
    text for the LEFTMOST match; '' when the pattern does not match
    (null only for null input). group=0 = whole match.

    Leftmost-greedy (or lazy) spans via the forward-backward segment
    resolution; alternation inside a segment is longest-wins. Each
    top-level segment costs one all-starts run.
    """
    _check_string(col)
    prog = compile_pattern(pattern)
    if group < 0 or group > prog.ngroups:
        raise IndexError(f"group {group} out of range (pattern has {prog.ngroups})")
    segs = _top_segments(prog)
    if group > 0 and not any(g == group for _, g in segs):
        raise ValueError(f"group {group} is quantified/nested — spans unrecoverable")
    seg_progs = [_segment_program(ast, prog.anchor_end and i == len(segs) - 1)
                 for i, (ast, _) in enumerate(segs)]
    padded, cp, cp_lens, byte_off = _codepoints(col)
    P = cp.shape[1] + 1

    # backward: suffix_ok[i][:, p] = segments i..k-1 can match from p;
    # each segment's (first, last) consistent ends kept for the forward pass
    e = torch.arange(P, dtype=torch.int32, device=cp.device)[None, :]
    in_range = e <= cp_lens[:, None]
    suffix_ok: List = [None] * (len(segs) + 1)
    suffix_ok[len(segs)] = (e == cp_lens[:, None]) if prog.anchor_end else in_range
    ends_by_seg: List = [None] * len(segs)
    for i in range(len(segs) - 1, -1, -1):
        m_i, ends_by_seg[i] = _all_starts(seg_progs[i], cp, cp_lens, endmask=suffix_ok[i + 1],
                                          want="last" if _greedy(segs[i][0]) else "first")
        suffix_ok[i] = m_i & in_range

    # leftmost match start = first p where the whole chain can match
    ok = suffix_ok[0]
    if prog.anchor_start:
        ok = ok & (e == 0)
    has = ok.any(dim=1)
    m_start = torch.argmax(ok.to(torch.uint8), dim=1)

    # forward: chain greedy / lazy consistent ends
    pos = m_start
    spans = {}
    for i, (_, gi) in enumerate(segs):
        nxt = torch.maximum(_gather1(ends_by_seg[i], pos).to(torch.int64), pos)  # -1: no match
        if gi is not None:
            spans[gi] = (pos, nxt)
        pos = nxt

    begin, end_ = (m_start, pos) if group == 0 else spans[group]
    return _substr_by_cp_span(col, padded, byte_off, begin, end_, has)


# the token loop checks every this many steps whether every row is done
_SPLIT_CHECK = 4


@op_boundary("strings.split_re")
def split_re(col: Column, pattern: str, limit: int = -1) -> List[Column]:
    """Spark split(str, regex, limit) — Java String.split semantics:
    limit > 0: at most `limit` tokens, last token = unsplit remainder;
    limit = -1 (Spark default): all tokens, trailing empties kept;
    limit = 0: all tokens, trailing empties removed.
    A zero-width separator match at position 0 is skipped (Java 8+).

    Returns a cudf-split-style list of K string columns; row r's token t
    is null for t >= that row's token count. The token loop stops once
    every row has taken its last token (checked every ``_SPLIT_CHECK``
    steps: one host sync each); the steps it skips would add only
    invalid tokens, so the result is the reference's.
    """
    _check_string(col)
    prog = compile_pattern(pattern)
    padded, cp, cp_lens, byte_off = _codepoints(col)
    dev = cp.device
    n, L = cp.shape
    P = L + 1
    parr = torch.arange(P, dtype=torch.int64, device=dev)[None, :]
    lens = cp_lens.to(torch.int64)

    matched, last_end = _all_starts(prog, cp, cp_lens, endmask=None, want="last")
    hit = matched & (parr <= lens[:, None])
    if prog.anchor_start:  # '^' matches only the string start
        hit = hit & (parr == 0)
    sep_end = torch.maximum(last_end.to(torch.int64), parr)  # greedy end per start

    # next separator-match start at or after q: a suffix minimum over the
    # hit starts, taken along dim 0 of the transpose (an outer-axis scan)
    INF = P + 1
    starts = torch.where(hit, parr, INF)
    nm = torch.cummin(starts.t().flip(0), dim=0).values.flip(0).t()
    nm = torch.cat([nm, torch.full((n, 1), INF, dtype=torch.int64, device=dev)], dim=1)

    K = max(min(limit if limit > 0 else L + 1, L + 1), 1)

    def next_match(search):
        ms = _gather1(nm, search)
        return ms, _gather1(sep_end, ms)

    pos = torch.zeros((n,), dtype=torch.int64, device=dev)
    search = torch.zeros_like(pos)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    tb, te, tv = [], [], []
    for t in range(K):
        ms, me = next_match(search)
        # Java 8: a zero-width match at the very beginning is skipped
        skip0 = (ms == 0) & (me <= ms) & (pos == 0)
        ms2, me2 = next_match(torch.where(skip0, 1, search))
        zero_w = me2 <= ms2
        found = (ms2 <= lens) & ~done
        take_rest = ~found | (limit > 0 and t == K - 1)
        tb.append(pos)
        te.append(torch.where(take_rest, lens, ms2))
        tv.append(~done)
        pos = torch.where(take_rest, lens, torch.where(zero_w, ms2, me2))
        search = torch.where(take_rest, INF, torch.where(zero_w, ms2 + 1, me2))
        done = done | take_rest
        if t % _SPLIT_CHECK == _SPLIT_CHECK - 1 and bool(done.all()):
            break
    tb, te, tv = torch.stack(tb, 1), torch.stack(te, 1), torch.stack(tv, 1)  # [N, K']

    counts = tv.sum(dim=1, dtype=torch.int32)
    if limit == 0:
        # drop trailing empty tokens; an empty INPUT still yields one
        # empty token (Java "".split(x) == [""])
        nonempty = tv & (te > tb)
        any_ne = nonempty.any(dim=1)
        last_ne = tv.shape[1] - 1 - torch.argmax(nonempty.flip(1).to(torch.uint8), dim=1)
        counts = torch.where(any_ne, last_ne + 1, (cp_lens == 0).to(torch.int64)).to(torch.int32)
    k_out = max(int(counts.max()) if n else 1, 1)

    cols: List[Column] = []
    for t in range(k_out):
        valid_t = counts > t
        out = _substr_by_cp_span(col, padded, byte_off, tb[:, t], te[:, t], valid_t)
        v = valid_t if col.validity is None else (valid_t & col.validity)
        cols.append(Column(dt.STRING, validity=v, offsets=out.offsets, chars=out.chars))
    return cols


@op_boundary("strings.replace_re")
def replace_re(col: Column, pattern: str, replacement: bytes) -> Column:
    """Spark regexp_replace(col, pattern, replacement) for patterns that
    cannot match the empty string (zero-width matches change Java's
    splice semantics in ways the split decomposition cannot express: they
    raise). Literal replacement only (no backrefs).

    Rides the split machinery: the text between separator matches,
    rejoined with the replacement as the glue (concat_ws semantics keep
    absent token slots silent)."""
    prog = compile_pattern(pattern)
    if bool(prog.accept[0]):
        raise ValueError("replace_re: pattern matches the empty string")
    if isinstance(replacement, str):
        replacement = replacement.encode()
    toks = split_re(col, pattern, -1)
    out = strings.concat(toks, separator=replacement, null_policy="skip")
    # concat_ws never yields null; restore the input's nulls
    return Column(dt.STRING, validity=col.validity, offsets=out.offsets, chars=out.chars)
