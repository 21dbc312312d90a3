"""Grammar-guided decoding: Lark-style EBNF -> incremental char-level
Earley recognizer -> token masks.

Reference surface: guided_grammar (endpoints/openai/protocol.py:268,
outlines CFGFSM) + the Lark-based incremental matcher
(common/grammar.py). Design here is scannerless: terminals compile to
character DFAs (the same engine as regex guidance), the grammar runs a
classic Earley recognizer whose chart extends one character at a time
— appending a column per char and popping it on backtrack, which makes
the vocabulary-trie walk for token masks a clean DFS. %ignore patterns
are allowed (repeatedly) in front of any terminal, matching lexer
skip semantics.

Supported Lark subset: `rule : alternatives`, `?rule`/`!rule` markers,
UPPERCASE terminal defs, "literals" (with \\-escapes), /regex/
terminals, ( groups ), postfix * + ?, |, // comments, %ignore, and
%import common.{WS, WS_INLINE, DIGIT, INT, SIGNED_NUMBER, NUMBER,
CNAME, ESCAPED_STRING, LETTER}. Start rule: "start" (or "root", or the
first rule defined).
"""

import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from aphrodite_tpu_torch.guided.regex_fsm import DFA, compile_regex

_COMMON_TERMINALS = {
    "WS": r"[ \t\r\n]+",
    "WS_INLINE": r"[ \t]+",
    "DIGIT": r"[0-9]",
    "LETTER": r"[A-Za-z]",
    "INT": r"[0-9]+",
    "SIGNED_INT": r"[+\-]?[0-9]+",
    "NUMBER": r"[0-9]+(\.[0-9]+)?([eE][+\-]?[0-9]+)?",
    "SIGNED_NUMBER": r"[+\-]?[0-9]+(\.[0-9]+)?([eE][+\-]?[0-9]+)?",
    "CNAME": r"[A-Za-z_][A-Za-z0-9_]*",
    "ESCAPED_STRING": r'"([^"\\]|\\.)*"',
}


def _escape_regex(text: str) -> str:
    out = []
    for c in text:
        out.append("\\" + c if c in ".*+?()[]{}|\\^$/" else c)
    return "".join(out)


# ---------------------------------------------------------------------------
# Lark-subset parsing


class _GrammarError(ValueError):
    pass


_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<regex>/(?:[^/\\\n]|\\.)+/[imslux]*)
  | (?P<name>[?!]?[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<op>->|[:|()*+?~\[\]])
""", re.VERBOSE)


def _lex(text: str) -> List[Tuple[str, str]]:
    toks = []
    i = 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            raise _GrammarError(f"grammar syntax error at {text[i:i+20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        toks.append((kind, m.group()))
    return toks


class _Parser:
    """Parses the Lark subset into {name: [alternative(sequence of
    symbols)]}; symbols are ("rule", name) or ("re", pattern)."""

    def __init__(self, text: str):
        self.rules: Dict[str, List[List[Tuple[str, str]]]] = {}
        self.ignores: List[str] = []
        self.start: Optional[str] = None
        self._anon = 0
        self._parse(text)

    def _new_rule(self, alts) -> str:
        self._anon += 1
        name = f"__anon_{self._anon}"
        self.rules[name] = alts
        return name

    def _parse(self, text: str) -> None:
        # Directives first (line-based), then rule bodies via the lexer.
        lines = []
        for raw in text.splitlines():
            s = raw.strip()
            if s.startswith("%ignore"):
                spec = s[len("%ignore"):].strip()
                if spec.startswith("/"):
                    body = spec[1:spec.rindex("/")]
                    self.ignores.append(body)
                elif spec.startswith('"'):
                    self.ignores.append(
                        _escape_regex(_unquote(spec)))
                elif spec in _COMMON_TERMINALS:
                    self.ignores.append(_COMMON_TERMINALS[spec])
                else:
                    raise _GrammarError(f"unsupported %ignore {spec!r}")
                continue
            if s.startswith("%import"):
                # %import common.WS [-> alias] — builtin table only.
                parts = s.split()
                ref = parts[1]
                if not ref.startswith("common."):
                    raise _GrammarError(f"unsupported {s!r}")
                name = ref[len("common."):]
                if name not in _COMMON_TERMINALS:
                    raise _GrammarError(f"unknown import {name!r}")
                alias = parts[3] if len(parts) > 3 and parts[2] == "->" \
                    else name
                self.rules[alias] = [[("re", _COMMON_TERMINALS[name])]]
                continue
            if s.startswith("%"):
                raise _GrammarError(f"unsupported directive {s!r}")
            lines.append(raw)
        toks = _lex("\n".join(lines))
        pos = 0
        while pos < len(toks):
            kind, val = toks[pos]
            if kind != "name":
                raise _GrammarError(f"expected rule name, got {val!r}")
            name = val.lstrip("?!")
            if pos + 1 >= len(toks) or toks[pos + 1][1] != ":":
                raise _GrammarError(f"expected ':' after {name!r}")
            pos += 2
            alts, pos = self._parse_alts(toks, pos, top=True)
            self.rules.setdefault(name, []).extend(alts)
            if self.start is None and name not in _COMMON_TERMINALS:
                self.start = name
        for pref in ("start", "root"):
            if pref in self.rules:
                self.start = pref
                break
        if self.start is None:
            raise _GrammarError("empty grammar")

    def _parse_alts(self, toks, pos, top=False):
        alts = []
        seq: List[Tuple[str, str]] = []
        while pos < len(toks):
            kind, val = toks[pos]
            if kind == "name" and top and pos + 1 < len(toks) and \
                    toks[pos + 1][1] == ":":
                break  # next rule definition
            if val == "|":
                alts.append(seq)
                seq = []
                pos += 1
                continue
            if val == ")":
                break
            sym, pos = self._parse_atom(toks, pos)
            # postfix quantifiers
            while pos < len(toks) and toks[pos][1] in ("*", "+", "?"):
                q = toks[pos][1]
                pos += 1
                inner = [sym]
                if q == "*":
                    r = self._new_rule([[]])
                    self.rules[r].append([("rule", r)] + inner)
                elif q == "+":
                    r = self._new_rule([list(inner)])
                    self.rules[r].append([("rule", r)] + inner)
                else:
                    r = self._new_rule([[], list(inner)])
                sym = ("rule", r)
            seq.append(sym)
        alts.append(seq)
        return alts, pos

    def _parse_atom(self, toks, pos):
        kind, val = toks[pos]
        if val == "(":
            alts, pos = self._parse_alts(toks, pos + 1)
            if pos >= len(toks) or toks[pos][1] != ")":
                raise _GrammarError("unbalanced (")
            return ("rule", self._new_rule(alts)), pos + 1
        if kind == "string":
            return ("re", _escape_regex(_unquote(val))), pos + 1
        if kind == "regex":
            body = val[1:val.rindex("/")]
            return ("re", body), pos + 1
        if kind == "name":
            name = val.lstrip("?!")
            if name in _COMMON_TERMINALS and name not in self.rules:
                return ("re", _COMMON_TERMINALS[name]), pos + 1
            return ("rule", name), pos + 1
        raise _GrammarError(f"unexpected {val!r}")


def _unquote(s: str) -> str:
    body = s[1:s.rindex('"')] if s.startswith('"') else s
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            n = body[i + 1]
            out.append({"n": "\n", "t": "\t", "r": "\r"}.get(n, n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# scannerless incremental Earley


class CFG:
    """Compiled grammar: rule -> alternatives of symbols, where a
    symbol is ("rule", name) or ("dfa", index into self.dfas)."""

    def __init__(self, text: str, alphabet: Set[str]):
        p = _Parser(text)
        self.start = p.start
        self.dfas: List[DFA] = []
        self.rules: Dict[str, List[List[Tuple[str, int]]]] = {}
        seen_re: Dict[str, int] = {}

        def dfa_of(pattern: str) -> int:
            idx = seen_re.get(pattern)
            if idx is None:
                idx = len(self.dfas)
                self.dfas.append(compile_regex(pattern, alphabet))
                seen_re[pattern] = idx
            return idx

        for name, alts in p.rules.items():
            self.rules[name] = [
                [(("dfa", dfa_of(v)) if k == "re" else ("rule", v))
                 for k, v in alt] for alt in alts]
        for name, alts in self.rules.items():
            for alt in alts:
                for k, v in alt:
                    if k == "rule" and v not in self.rules:
                        raise _GrammarError(f"undefined rule {v!r}")
        self.ignore_dfa: Optional[DFA] = None
        if p.ignores:
            self.ignore_dfa = compile_regex(
                "|".join(f"({pat})" for pat in p.ignores), alphabet)
        # Nullable rules (Aycock-Horspool prediction fix).
        nullable: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, alts in self.rules.items():
                if name in nullable:
                    continue
                for alt in alts:
                    if all(k == "rule" and v in nullable
                           for k, v in alt):
                        nullable.add(name)
                        changed = True
                        break
        self.nullable = nullable


# An Earley item: (rule, alt_idx, dot, origin_column).
# A terminal scan: (rule, alt_idx, dot, origin, dfa_idx, dfa_state)
# -- mid-terminal, the dot still points AT the terminal.
# An ignore scan: (rule, alt_idx, dot, origin, -1, ig_state) -- on
# completion the item re-enters closure at the same dot.


class _Chart:
    __slots__ = ("items", "scans")

    def __init__(self):
        self.items: Set[Tuple[str, int, int, int]] = set()
        self.scans: Set[Tuple[str, int, int, int, int, int]] = set()


class GrammarTokenFSM:
    """TokenFSM-compatible interface over the Earley recognizer.

    States are integers interning (chart column list) snapshots; the
    chart is append-only per consumed char, so the vocabulary-trie walk
    appends/pops columns."""

    def __init__(self, cfg: CFG, tokenizer, vocab_size: int):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.eos_token_id = tokenizer.eos_token_id
        from aphrodite_tpu_torch.guided.token_fsm import _get_vocab_index

        vocab = _get_vocab_index(tokenizer, vocab_size)
        self._decode = vocab.token_strings
        self._trie = vocab.trie
        self.mask_words = (vocab_size + 31) // 32
        c0 = _Chart()
        for ai in range(len(cfg.rules[cfg.start])):
            c0.items.add((cfg.start, ai, 0, 0))
        self._closure([c0], c0)
        self._states: List[List[_Chart]] = [[c0]]
        self._cache: Dict[int, Tuple[np.ndarray, Dict[int, int]]] = {}

    # ---- Earley mechanics ------------------------------------------------

    def _closure(self, chart: List["_Chart"], col: _Chart) -> None:
        cfg = self.cfg
        here = len(chart) - 1
        work = list(col.items)
        while work:
            rule, ai, dot, org = work.pop()
            alt = cfg.rules[rule][ai]
            if dot == len(alt):  # complete
                for p_rule, p_ai, p_dot, p_org in list(
                        chart[org].items):
                    p_alt = cfg.rules[p_rule][p_ai]
                    if p_dot < len(p_alt) and \
                            p_alt[p_dot] == ("rule", rule):
                        adv = (p_rule, p_ai, p_dot + 1, p_org)
                        if adv not in col.items:
                            col.items.add(adv)
                            work.append(adv)
                continue
            kind, v = alt[dot]
            if kind == "rule":
                for bi in range(len(cfg.rules[v])):
                    it = (v, bi, 0, here)
                    if it not in col.items:
                        col.items.add(it)
                        work.append(it)
                if v in cfg.nullable:
                    adv = (rule, ai, dot + 1, org)
                    if adv not in col.items:
                        col.items.add(adv)
                        work.append(adv)
            else:  # terminal: open a scan (+ optional leading ignore)
                dfa = cfg.dfas[v]
                col.scans.add((rule, ai, dot, org, v, dfa.start))
                if dfa.start in dfa.accepting:
                    # Empty-matching terminal (e.g. /x*/): also advance
                    # past it without consuming.
                    adv = (rule, ai, dot + 1, org)
                    if adv not in col.items:
                        col.items.add(adv)
                        work.append(adv)
                if cfg.ignore_dfa is not None:
                    col.scans.add((rule, ai, dot, org, -1,
                                   cfg.ignore_dfa.start))

    def _advance(self, chart: List["_Chart"],
                 c: str) -> Optional[_Chart]:
        cfg = self.cfg
        new = _Chart()
        prev = chart[-1]
        for rule, ai, dot, org, di, ds in prev.scans:
            dfa = cfg.ignore_dfa if di < 0 else cfg.dfas[di]
            t = dfa.step(ds, c)
            if t < 0:
                continue
            new.scans.add((rule, ai, dot, org, di, t))
            if t in dfa.accepting:
                if di < 0:
                    # ignore consumed: re-enter closure at the same dot
                    # (allows another ignore round or the terminal).
                    new.items.add((rule, ai, dot, org))
                else:
                    new.items.add((rule, ai, dot + 1, org))
        if not new.scans and not new.items:
            return None
        chart.append(new)
        self._closure(chart, new)
        # Re-opening scans for re-entered items happens in closure; but
        # closure only opens scans for items whose dot is at a terminal
        # -- including the ignore re-entries. Completed start items stay
        # in new.items for acceptance checks.
        return new

    def _accepts(self, chart: List["_Chart"]) -> bool:
        n_alts = len(self.cfg.rules[self.cfg.start])
        return any((self.cfg.start, ai, len(self.cfg.rules[
            self.cfg.start][ai]), 0) in chart[-1].items
            for ai in range(n_alts))

    # ---- TokenFSM interface -----------------------------------------------

    def initial_state(self) -> int:
        return 0

    def _compute_state(self, state: int):
        cached = self._cache.get(state)
        if cached is not None:
            return cached
        chart = self._states[state]
        mask = np.zeros(self.mask_words, np.uint32)
        nexts: Dict[int, int] = {}

        base_len = len(chart)

        def dfs(node):
            for tid in node.token_ids:
                mask[tid >> 5] |= np.uint32(1 << (tid & 31))
                nexts.setdefault(tid, -2)  # lazily materialized
            for c, child in node.children.items():
                if self._advance(chart, c) is None:
                    continue
                dfs(child)
                chart.pop()

        dfs(self._trie)
        assert len(chart) == base_len
        if self._accepts(chart) and self.eos_token_id is not None:
            e = self.eos_token_id
            mask[e >> 5] |= np.uint32(1 << (e & 31))
            nexts[e] = state
        self._cache[state] = (mask, nexts)
        return mask, nexts

    def allowed_mask(self, state: int) -> np.ndarray:
        return self._compute_state(state)[0]

    def next_state(self, state: int, token_id: int) -> int:
        mask, nexts = self._compute_state(state)
        nxt = nexts.get(token_id, -1)
        if nxt != -2:
            return nxt
        # Materialize: extend a COPY of the chart by the token's chars.
        chart = list(self._states[state])
        for c in self._decode[token_id]:
            if self._advance(chart, c) is None:
                nexts[token_id] = -1
                return -1
        self._states.append(chart)
        nexts[token_id] = len(self._states) - 1
        return nexts[token_id]

    def is_accepting(self, state: int) -> bool:
        return self._accepts(self._states[state])
