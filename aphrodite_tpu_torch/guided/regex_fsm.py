"""Regex -> DFA compiler for guided decoding.

From-scratch replacement for the reference's outlines/lm-format-enforcer
dependency (aphrodite/modeling/guided_decoding/ — neither library exists
in this environment): a practical regex subset is compiled via Thompson
NFA construction + subset determinization, over an explicit alphabet
(the characters that actually occur in the tokenizer vocabulary plus any
literals in the pattern).

Supported syntax: literals, escapes (\\d \\w \\s \\n \\t \\r \\\\ and
escaped metachars), char classes [a-z0-9_] with ranges and negation,
'.', quantifiers * + ? {m} {m,} {m,n}, alternation |, groups ( ).
Matching is full-match (anchored both ends), as guided decoding needs.
"""

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

DIGITS = set("0123456789")
WORD = set("abcdefghijklmnopqrstuvwxyz"
           "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
SPACE = set(" \t\n\r\f\v")
META = set(".*+?()[]{}|\\^$")


class _Node:
    """Regex AST."""

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.__dict__.update(kw)


def _parse(pattern: str, alphabet: Set[str]) -> _Node:
    pos = 0

    def peek():
        return pattern[pos] if pos < len(pattern) else None

    def take():
        nonlocal pos
        c = pattern[pos]
        pos += 1
        return c

    def parse_escape() -> Set[str]:
        c = take()
        if c == "d":
            return DIGITS & alphabet
        if c == "w":
            return WORD & alphabet
        if c == "s":
            return SPACE & alphabet
        if c == "D":
            return alphabet - DIGITS
        if c == "W":
            return alphabet - WORD
        if c == "S":
            return alphabet - SPACE
        if c == "n":
            return {"\n"}
        if c == "t":
            return {"\t"}
        if c == "r":
            return {"\r"}
        return {c}  # escaped literal/metachar

    def parse_class() -> Set[str]:
        negate = False
        chars: Set[str] = set()
        if peek() == "^":
            take()
            negate = True
        first = True
        while True:
            c = peek()
            if c is None:
                raise ValueError("unterminated character class")
            if c == "]" and not first:
                take()
                break
            first = False
            take()
            if c == "\\":
                chars |= parse_escape()
                continue
            if peek() == "-" and pos + 1 < len(pattern) and \
                    pattern[pos + 1] != "]":
                take()  # '-'
                hi = take()
                chars |= {chr(x) for x in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        if negate:
            return alphabet - chars
        return chars

    def parse_atom() -> Optional[_Node]:
        c = peek()
        if c is None or c in ")|":
            return None
        take()
        if c == "(":
            # Optional non-capturing prefix (?: ).
            if peek() == "?":
                take()
                if peek() == ":":
                    take()
                else:
                    raise ValueError("unsupported group modifier")
            inner = parse_alt()
            if peek() != ")":
                raise ValueError("unbalanced parenthesis")
            take()
            return inner
        if c == "[":
            return _Node("class", chars=frozenset(parse_class()))
        if c == ".":
            return _Node("class",
                         chars=frozenset(alphabet - {"\n"}))
        if c == "\\":
            return _Node("class", chars=frozenset(parse_escape()))
        if c in "*+?{":
            raise ValueError(f"dangling quantifier {c!r}")
        return _Node("class", chars=frozenset({c}))

    def parse_quantified() -> Optional[_Node]:
        atom = parse_atom()
        if atom is None:
            return None
        while True:
            c = peek()
            if c == "*":
                take()
                atom = _Node("star", child=atom)
            elif c == "+":
                take()
                atom = _Node("concat",
                             parts=[atom, _Node("star", child=atom)])
            elif c == "?":
                take()
                atom = _Node("opt", child=atom)
            elif c == "{":
                take()
                spec = ""
                while peek() is not None and peek() != "}":
                    spec += take()
                if peek() != "}":
                    raise ValueError("unterminated {}")
                take()
                if "," in spec:
                    lo_s, hi_s = spec.split(",", 1)
                    lo = int(lo_s or 0)
                    hi = int(hi_s) if hi_s else None
                else:
                    lo = hi = int(spec)
                parts = [atom] * lo
                if hi is None:
                    parts.append(_Node("star", child=atom))
                else:
                    parts += [_Node("opt", child=atom)] * (hi - lo)
                atom = _Node("concat", parts=parts) if parts else \
                    _Node("eps")
            else:
                break
        return atom

    def parse_concat() -> _Node:
        parts = []
        while True:
            a = parse_quantified()
            if a is None:
                break
            parts.append(a)
        if not parts:
            return _Node("eps")
        if len(parts) == 1:
            return parts[0]
        return _Node("concat", parts=parts)

    def parse_alt() -> _Node:
        branches = [parse_concat()]
        while peek() == "|":
            take()
            branches.append(parse_concat())
        if len(branches) == 1:
            return branches[0]
        return _Node("alt", branches=branches)

    node = parse_alt()
    if pos != len(pattern):
        raise ValueError(f"trailing regex input at {pos}")
    return node


class NFA:
    def __init__(self):
        self.transitions: List[Dict[str, Set[int]]] = []
        self.eps: List[Set[int]] = []

    def new_state(self) -> int:
        self.transitions.append({})
        self.eps.append(set())
        return len(self.eps) - 1

    def add(self, s: int, c: str, t: int) -> None:
        self.transitions[s].setdefault(c, set()).add(t)

    def add_eps(self, s: int, t: int) -> None:
        self.eps[s].add(t)


def _build_nfa(node: _Node, nfa: NFA) -> Tuple[int, int]:
    start = nfa.new_state()
    end = nfa.new_state()
    if node.kind == "eps":
        nfa.add_eps(start, end)
    elif node.kind == "class":
        for c in node.chars:
            nfa.add(start, c, end)
    elif node.kind == "concat":
        cur = start
        for part in node.parts:
            s, e = _build_nfa(part, nfa)
            nfa.add_eps(cur, s)
            cur = e
        nfa.add_eps(cur, end)
    elif node.kind == "alt":
        for b in node.branches:
            s, e = _build_nfa(b, nfa)
            nfa.add_eps(start, s)
            nfa.add_eps(e, end)
    elif node.kind == "star":
        s, e = _build_nfa(node.child, nfa)
        nfa.add_eps(start, s)
        nfa.add_eps(e, s)
        nfa.add_eps(start, end)
        nfa.add_eps(e, end)
    elif node.kind == "opt":
        s, e = _build_nfa(node.child, nfa)
        nfa.add_eps(start, s)
        nfa.add_eps(e, end)
        nfa.add_eps(start, end)
    else:
        raise ValueError(node.kind)
    return start, end


class DFA:
    """Deterministic automaton with full-match semantics."""

    def __init__(self, transitions: List[Dict[str, int]],
                 accepting: Set[int], start: int):
        self.transitions = transitions
        self.accepting = accepting
        self.start = start

    def step(self, state: int, c: str) -> int:
        """-1 = dead."""
        return self.transitions[state].get(c, -1)

    def walk(self, state: int, text: str) -> int:
        for c in text:
            state = self.step(state, c)
            if state < 0:
                return -1
        return state

    def fullmatch(self, text: str) -> bool:
        s = self.walk(self.start, text)
        return s >= 0 and s in self.accepting

    @property
    def num_states(self) -> int:
        return len(self.transitions)


def compile_regex(pattern: str, alphabet: Set[str]) -> DFA:
    """Compile `pattern` into a DFA over `alphabet`."""
    # Literal characters in the pattern must be in the alphabet so plain
    # strings always compile.
    alphabet = set(alphabet) | {c for c in pattern if c not in META}
    node = _parse(pattern, alphabet)
    nfa = NFA()
    start, end = _build_nfa(node, nfa)

    def eps_closure(states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        out = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = eps_closure(frozenset([start]))
    index: Dict[FrozenSet[int], int] = {start_set: 0}
    transitions: List[Dict[str, int]] = [{}]
    accepting: Set[int] = set()
    if end in start_set:
        accepting.add(0)
    work = [start_set]
    while work:
        cur = work.pop()
        ci = index[cur]
        moves: Dict[str, Set[int]] = {}
        for s in cur:
            for c, targets in nfa.transitions[s].items():
                moves.setdefault(c, set()).update(targets)
        for c, targets in moves.items():
            nxt = eps_closure(frozenset(targets))
            ti = index.get(nxt)
            if ti is None:
                ti = len(transitions)
                index[nxt] = ti
                transitions.append({})
                if end in nxt:
                    accepting.add(ti)
                work.append(nxt)
            transitions[ci][c] = ti
    return DFA(transitions, accepting, 0)
