"""Labeled binary trees + a lightweight parser for RNTN-style models.

Capability match of the reference's ``models/featuredetectors/autoencoder/
recursive/Tree.java`` (471 LoC general labeled tree with gold labels, spans,
error accumulation) and the role of ``text/corpora/treeparser/TreeParser
.java:41`` (the reference drives an external OpenNLP/UIMA parser; here the
equivalents are (a) a Penn-Treebank s-expression reader for annotated
corpora like Stanford Sentiment, and (b) a trivial right-branching
binarizer for raw sentences so RNTN runs without an external parser).

Port of ``deeplearning4j_tpu/text/tree.py``: host code, copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator


@dataclass
class Tree:
    label: str = ""
    gold_label: int = -1
    word: str | None = None                  # leaves only
    children: list["Tree"] = field(default_factory=list)
    prediction: object = None                # filled by models
    error: float = 0.0

    # ------------------------------------------------------------------ structure
    def is_leaf(self) -> bool:
        return not self.children

    def is_pre_terminal(self) -> bool:
        return len(self.children) == 1 and self.children[0].is_leaf()

    def leaves(self) -> list["Tree"]:
        if self.is_leaf():
            return [self]
        return [l for c in self.children for l in c.leaves()]

    def words(self) -> list[str]:
        return [l.word for l in self.leaves() if l.word is not None]

    def subtrees(self) -> Iterator["Tree"]:
        yield self
        for c in self.children:
            yield from c.subtrees()

    def depth(self) -> int:
        return 1 if self.is_leaf() else 1 + max(c.depth() for c in self.children)

    def assign_spans(self, start: int = 0) -> int:
        """Assign (start, end) leaf spans to every subtree; call on the ROOT.
        Returns this subtree's end position."""
        if self.is_leaf():
            self._span = (start, start + 1)
            return start + 1
        pos = start
        for c in self.children:
            pos = c.assign_spans(pos)
        self._span = (start, pos)
        return pos

    def span(self) -> tuple[int, int]:
        """(start, end) token span in the root's leaf order.  Requires
        ``root.assign_spans()`` first; standalone trees get (0, n_leaves)."""
        if not hasattr(self, "_span"):
            self.assign_spans()
        return self._span

    def error_sum(self) -> float:
        return sum(t.error for t in self.subtrees())

    # ------------------------------------------------------------------ serde
    def to_sexpr(self) -> str:
        if self.is_leaf():
            return self.word or ""
        kids = " ".join(c.to_sexpr() for c in self.children)
        return f"({self.label} {kids})"

    def __str__(self) -> str:
        return self.to_sexpr()


def parse_sexpr(s: str) -> Tree:
    """Penn-treebank style: ``(3 (2 word) (1 (0 other) (2 words)))`` — the
    node label may be a sentiment class id or a syntactic tag."""
    tokens = s.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def parse() -> Tree:
        nonlocal pos
        assert tokens[pos] == "(", f"expected ( at {pos}"
        pos += 1
        label = tokens[pos]
        pos += 1
        node = Tree(label=label)
        try:
            node.gold_label = int(label)
        except ValueError:
            pass
        while tokens[pos] != ")":
            if tokens[pos] == "(":
                node.children.append(parse())
            else:
                node.children.append(Tree(word=tokens[pos], label=label))
                pos += 1
        pos += 1
        return node

    tree = parse()
    return tree


def right_branching(words: list[str], label: int = -1) -> Tree:
    """Binarize a raw token list right-branching — lets RNTN train without an
    external constituency parser (documented deviation: the reference calls
    out to OpenNLP/ClearTK)."""
    assert words
    if len(words) == 1:
        return Tree(word=words[0], gold_label=label)
    node = Tree(gold_label=label)
    node.children = [Tree(word=words[0], gold_label=label),
                     right_branching(words[1:], label)]
    return node


def binarize(tree: Tree) -> Tree:
    """Left-factor n-ary nodes into binary ones (RNTN needs binary trees)."""
    if tree.is_leaf():
        return tree
    kids = [binarize(c) for c in tree.children]
    while len(kids) > 2:
        merged = Tree(label=tree.label, gold_label=tree.gold_label,
                      children=[kids[0], kids[1]])
        kids = [merged] + kids[2:]
    out = Tree(label=tree.label, gold_label=tree.gold_label, word=tree.word)
    out.children = kids
    return out
