"""Token trie for closed-set constrained decoding (counterpart of
ofasys_tpu/utils/trie.py)."""

from __future__ import annotations

from typing import Dict, Iterable, List


class Trie:
    def __init__(self, eos: int = -1):
        self.root: Dict = {}
        self.eos = eos

    def insert(self, tokens: Iterable[int]):
        node = self.root
        for t in tokens:
            node = node.setdefault(int(t), {})
        node[self.eos] = {}

    def get_next_layer(self, prefix: Iterable[int]) -> List[int]:
        """Allowed next tokens after ``prefix`` (empty list if prefix is not
        in the trie)."""
        node = self.root
        for t in prefix:
            node = node.get(int(t))
            if node is None:
                return []
        return list(node.keys())

    def __contains__(self, tokens) -> bool:
        node = self.root
        for t in tokens:
            node = node.get(int(t))
            if node is None:
                return False
        return True
