"""Token-level FSM: DFA x tokenizer vocabulary.

The DFA operates on characters; generation operates on tokens. For each
DFA state we lazily compute (a) the set of vocabulary tokens whose full
string keeps the automaton alive, exposed as a packed uint32 bitmask the
sampler applies in-graph, and (b) per-token next states. Results are
cached per state — generation typically visits a handful of states.

This replaces the reference's outlines FSM index (guided_decoding/
outlines_logits_processors.py) which performs the same vocabulary x DFA
product, and its host-side logits masking (we upload packed masks and
mask on device instead).
"""

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from aphrodite_tpu_torch.guided.regex_fsm import DFA, compile_regex


class _TrieNode:
    __slots__ = ("children", "token_ids")

    def __init__(self):
        self.children: Dict[str, "_TrieNode"] = {}
        self.token_ids: List[int] = []


def _build_vocab_trie(vocab: List[Tuple[int, str]]) -> _TrieNode:
    root = _TrieNode()
    for tid, text in vocab:
        node = root
        for c in text:
            nxt = node.children.get(c)
            if nxt is None:
                nxt = _TrieNode()
                node.children[c] = nxt
            node = nxt
        node.token_ids.append(tid)
    return root


class _VocabIndex:
    """Spec-independent tokenizer artifacts, shared by every FSM built
    against the same tokenizer: decoded token strings, the vocab trie,
    and the character alphabet. Building these costs two O(vocab)
    single-token decode scans — per TOKENIZER, not per spec (the r4
    version re-scanned the vocabulary for every new guided spec)."""

    def __init__(self, tokenizer, vocab_size: int) -> None:
        self.vocab_size = vocab_size
        self.token_strings = self._build_token_strings(
            tokenizer, vocab_size)
        self.trie = _build_vocab_trie(
            [(tid, s) for tid, s in enumerate(self.token_strings) if s])
        self.alphabet = set()
        for s in self.token_strings:
            self.alphabet.update(s)
        self.alphabet.discard("�")

    @staticmethod
    def _build_token_strings(tokenizer, vocab_size: int) -> List[str]:
        """Token id -> decoded text. Uses batched single-token decode via
        convert_ids_to_tokens + convert_tokens_to_string semantics."""
        strings = [""] * vocab_size
        special = set(tokenizer.all_special_ids or [])
        for tid in range(vocab_size):
            if tid in special:
                continue  # specials never match guided grammars
            try:
                s = tokenizer.decode([tid])
            except Exception:
                s = ""
            if "�" in s:
                # Partial-byte tokens can't be validated at char level;
                # excluded (conservative, like outlines' byte handling
                # caveat for char-level FSMs).
                s = ""
            strings[tid] = s
        return strings


_VOCAB_CACHE: Dict[Tuple[int, int], _VocabIndex] = {}
_VOCAB_LOCK = threading.Lock()


def _get_vocab_index(tokenizer, vocab_size: int) -> _VocabIndex:
    key = (id(tokenizer), vocab_size)
    with _VOCAB_LOCK:
        idx = _VOCAB_CACHE.get(key)
    if idx is not None:
        return idx
    idx = _VocabIndex(tokenizer, vocab_size)
    with _VOCAB_LOCK:
        return _VOCAB_CACHE.setdefault(key, idx)


class TokenFSM:
    """Per-request guided-decoding automaton."""

    def __init__(self, dfa: DFA, tokenizer, vocab_size: int) -> None:
        self.dfa = dfa
        self.vocab_size = vocab_size
        self.eos_token_id = tokenizer.eos_token_id
        vocab = _get_vocab_index(tokenizer, vocab_size)
        self._decode = vocab.token_strings
        self._trie = vocab.trie
        self.mask_words = (vocab_size + 31) // 32
        # state -> (packed mask uint32[mask_words], {token_id: next_state})
        self._cache: Dict[int, Tuple[np.ndarray, Dict[int, int]]] = {}

    def _compute_state(self, state: int) -> Tuple[np.ndarray,
                                                  Dict[int, int]]:
        cached = self._cache.get(state)
        if cached is not None:
            return cached
        mask = np.zeros(self.mask_words, np.uint32)
        nexts: Dict[int, int] = {}
        stack = [(self._trie, state)]
        while stack:
            node, s = stack.pop()
            for tid in node.token_ids:
                mask[tid >> 5] |= np.uint32(1 << (tid & 31))
                nexts[tid] = s
            for c, child in node.children.items():
                t = self.dfa.step(s, c)
                if t >= 0:
                    stack.append((child, t))
        if state in self.dfa.accepting and self.eos_token_id is not None:
            e = self.eos_token_id
            mask[e >> 5] |= np.uint32(1 << (e & 31))
            nexts[e] = state
        self._cache[state] = (mask, nexts)
        return mask, nexts

    def initial_state(self) -> int:
        return self.dfa.start

    def allowed_mask(self, state: int) -> np.ndarray:
        return self._compute_state(state)[0]

    def next_state(self, state: int, token_id: int) -> int:
        _, nexts = self._compute_state(state)
        return nexts.get(token_id, -1)

    def is_accepting(self, state: int) -> bool:
        return state in self.dfa.accepting


_FSM_CACHE: Dict[Tuple[int, str], TokenFSM] = {}


def get_token_fsm(kind: str, spec: str, tokenizer,
                  vocab_size: int) -> TokenFSM:
    """kind in {regex, json, choice, json_object}; cached per tokenizer."""
    key = (id(tokenizer), f"{kind}:{spec}")
    fsm = _FSM_CACHE.get(key)
    if fsm is not None:
        return fsm
    alphabet = _get_vocab_index(tokenizer, vocab_size).alphabet
    if kind == "regex":
        pattern = spec
    elif kind == "choice":
        import json as _json
        import re as _re

        choices = _json.loads(spec)
        pattern = "|".join(_re.escape(c) if False else _escape(c)
                           for c in choices)
    elif kind == "json":
        from aphrodite_tpu_torch.guided.json_schema import schema_to_regex
        import json as _json

        pattern = schema_to_regex(_json.loads(spec))
    elif kind == "json_object":
        from aphrodite_tpu_torch.guided.json_schema import \
            ANY_JSON_OBJECT_REGEX

        pattern = ANY_JSON_OBJECT_REGEX
    elif kind == "grammar":
        from aphrodite_tpu_torch.guided.grammar_fsm import (
            CFG, GrammarTokenFSM)

        fsm = GrammarTokenFSM(CFG(spec, alphabet), tokenizer,
                              vocab_size)
        _FSM_CACHE[key] = fsm
        return fsm
    else:
        raise ValueError(f"unknown guided kind {kind!r}")
    dfa = compile_regex(pattern, alphabet)
    fsm = TokenFSM(dfa, tokenizer, vocab_size)
    _FSM_CACHE[key] = fsm
    return fsm


# ---------------------------------------------------------------------------
# Off-thread compilation (reference builds outlines FSMs asynchronously,
# guided_decoding/__init__.py:11-40). The engine parks guided requests
# until the future resolves so a large JSON schema never stalls the step
# loop for in-flight requests.
# ---------------------------------------------------------------------------

_BUILD_POOL: Optional[ThreadPoolExecutor] = None
_PENDING: Dict[Tuple[int, str], Future] = {}
_PENDING_LOCK = threading.Lock()


def get_token_fsm_future(kind: str, spec: str, tokenizer,
                         vocab_size: int) -> "Future[TokenFSM]":
    """Single-flight async build: a completed future for cached specs,
    one shared in-flight future otherwise. Thread-safe."""
    global _BUILD_POOL
    key = (id(tokenizer), f"{kind}:{spec}")
    fsm = _FSM_CACHE.get(key)
    if fsm is not None:
        f: Future = Future()
        f.set_result(fsm)
        return f
    with _PENDING_LOCK:
        f = _PENDING.get(key)
        if f is not None:
            return f
        if _BUILD_POOL is None:
            _BUILD_POOL = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="fsm-build")
        f = _BUILD_POOL.submit(get_token_fsm, kind, spec, tokenizer,
                               vocab_size)
        _PENDING[key] = f
        f.add_done_callback(
            lambda _f, _k=key: _PENDING.pop(_k, None))
        return f


def _escape(text: str) -> str:
    """Escape a literal for our regex subset."""
    out = []
    for c in text:
        if c in ".*+?()[]{}|\\^$":
            out.append("\\" + c)
        else:
            out.append(c)
    return "".join(out)
