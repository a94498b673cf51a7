"""Treebank constituency parser: raw text -> labeled trees for RNTN.

Capability parity with the reference's ``text/corpora/treeparser/
TreeParser.java:41`` (``getTrees(text)``: sentence-segment, tokenize, run a
constituency parser, build ``Tree``s) — there the parsing itself is an
external OpenNLP/ClearTK analysis engine; here it is self-contained:

- preterminals come from the :class:`~.annotator.AveragedPerceptronTagger`
  (emission distributions, not hard tags — ambiguity survives into the
  chart),
- structure comes from probabilistic CKY over a binary PCFG with unary
  closure: either the vendored default grammar (covers the tagger's
  universal-ish tagset) or one induced from any s-expression treebank via
  :meth:`Grammar.from_trees`,
- a low-probability glue rule guarantees a parse for any input, replacing
  the old right-branching fallback with "worst case glue, not always glue".

Output trees are :class:`~.tree.Tree`; ``binarize()`` makes them RNTN-ready.

Port of ``deeplearning4j_tpu/text/treeparser.py``: host code, copied.
"""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field

from .annotator import AveragedPerceptronTagger, SentenceAnnotator
from .tokenization import DefaultTokenizerFactory
from .tree import Tree, binarize

GLUE = "X"                       # universal fallback nonterminal
_GLUE_LOGP = math.log(1e-4)


@dataclass
class Grammar:
    """Binary PCFG + unary rules, log-prob weighted.

    ``binary[(B, C)] -> list[(A, logp)]``; ``unary[B] -> list[(A, logp)]``.
    Terminals are POS tags (the tagger provides tag distributions per word).
    """

    binary: dict = field(default_factory=lambda: defaultdict(list))
    unary: dict = field(default_factory=lambda: defaultdict(list))
    start: str = "S"

    def add_binary(self, a: str, b: str, c: str, p: float) -> None:
        self.binary[(b, c)].append((a, math.log(p)))

    def add_unary(self, a: str, b: str, p: float) -> None:
        self.unary[b].append((a, math.log(p)))

    # ------------------------------------------------------------- vendored
    @classmethod
    def default(cls) -> "Grammar":
        """Hand-written grammar over the vendored tagger's tagset
        (DET/ADJ/NOUN/VERB/ADV/ADP/PRON/CONJ/NUM/.) — small-English
        declarative coverage; induce from a treebank for more."""
        g = cls()
        # NP
        g.add_unary("NBAR", "NOUN", 0.7)
        g.add_binary("NBAR", "ADJ", "NBAR", 0.2)
        g.add_binary("NBAR", "NOUN", "NBAR", 0.1)
        g.add_binary("NP", "DET", "NBAR", 0.5)
        g.add_binary("NP", "NUM", "NBAR", 0.1)
        g.add_unary("NP", "NBAR", 0.2)
        g.add_unary("NP", "PRON", 0.2)
        # PP
        g.add_binary("PP", "ADP", "NP", 1.0)
        # VP
        g.add_unary("VP", "VERB", 0.3)
        g.add_binary("VP", "VERB", "NP", 0.3)
        g.add_binary("VP", "VP", "PP", 0.15)
        g.add_binary("VP", "VP", "ADV", 0.1)
        g.add_binary("VP", "ADV", "VP", 0.05)
        g.add_binary("VP", "VERB", "ADJ", 0.05)
        g.add_binary("VP", "VP", "NP", 0.05)
        # NP conj / PP attachment to NP
        g.add_binary("NP", "NP", "CONJP", 0.05)
        g.add_binary("CONJP", "CONJ", "NP", 1.0)
        g.add_binary("NP", "NP", "PP", 0.05)
        # S
        g.add_binary("S", "NP", "VP", 0.8)
        g.add_binary("S", "S", ".", 0.15)
        g.add_binary("S", "S", "CONJS", 0.05)
        g.add_binary("CONJS", "CONJ", "S", 1.0)
        return g

    # ------------------------------------------------------------- induced
    @classmethod
    def from_trees(cls, trees, start: str = "S") -> "Grammar":
        """Maximum-likelihood PCFG from binarized treebank trees whose
        preterminals are POS tags (the interchange role of the reference's
        ``TreeFactory``/``TreeVectorization`` corpus path)."""
        bin_counts = defaultdict(lambda: defaultdict(int))
        un_counts = defaultdict(lambda: defaultdict(int))
        for t in trees:
            for node in binarize(t).subtrees():
                if node.is_leaf() or node.is_pre_terminal():
                    continue
                kids = [c.label for c in node.children]
                if len(kids) == 2:
                    bin_counts[node.label][tuple(kids)] += 1
                elif len(kids) == 1:
                    un_counts[node.label][kids[0]] += 1
        g = cls(start=start)
        for a, prods in bin_counts.items():
            total = sum(prods.values()) + sum(un_counts.get(a, {}).values())
            for (b, c), n in prods.items():
                g.add_binary(a, b, c, n / total)
        for a, prods in un_counts.items():
            total = sum(prods.values()) + sum(bin_counts.get(a, {}).values())
            for b, n in prods.items():
                g.add_unary(a, b, n / total)
        return g


class TreebankParser:
    """``getTrees(text)`` parity: sentence-segment, tokenize, CKY-parse.

    Always returns a tree: spans the grammar cannot derive are joined by
    the glue rule at negligible probability, so well-covered substructure
    is preserved even for out-of-grammar sentences."""

    def __init__(self, grammar: Grammar | None = None,
                 tagger: AveragedPerceptronTagger | None = None,
                 tokenizer_factory=None,
                 sentence_annotator: SentenceAnnotator | None = None):
        self.grammar = grammar or Grammar.default()
        self.tagger = tagger or AveragedPerceptronTagger.default()
        self.tf = tokenizer_factory or DefaultTokenizerFactory()
        self.sentences = sentence_annotator or SentenceAnnotator()

    # ------------------------------------------------------------------ api
    def get_trees(self, text: str) -> list[Tree]:
        """Sentences -> trees (mirror of ``TreeParser.getTrees``)."""
        out = []
        for sent in self.sentences.annotate(text):
            tokens = self.tf.create(sent).get_tokens()
            if tokens:
                out.append(self.parse_tokens(tokens))
        return out

    def parse_tokens(self, tokens: list[str]) -> Tree:
        """Probabilistic CKY with unary closure + glue fallback."""
        if not tokens:
            raise ValueError("parse_tokens needs at least one token")
        n = len(tokens)
        emissions = self.tagger.emissions(tokens)        # (n, n_tags)
        classes = self.tagger.classes

        # chart[i][j]: dict sym -> (logp, backpointer)
        # backpointer: ("tag", tag) | ("un", child_sym) | ("bin", k, B, C)
        chart = [[dict() for _ in range(n + 1)] for _ in range(n + 1)]

        for i in range(n):
            cell = chart[i][i + 1]
            for j, tag in enumerate(classes):
                p = float(emissions[i, j])
                if p > 1e-6:
                    cell[tag] = (math.log(p), ("tag", tag))
            self._unary_closure(cell)

        for span in range(2, n + 1):
            for i in range(n - span + 1):
                j = i + span
                cell = chart[i][j]
                for k in range(i + 1, j):
                    left, right = chart[i][k], chart[k][j]
                    for b, (lp_b, _) in left.items():
                        for c, (lp_c, _) in right.items():
                            for a, lp_rule in self.grammar.binary.get(
                                    (b, c), ()):
                                lp = lp_b + lp_c + lp_rule
                                if a not in cell or lp > cell[a][0]:
                                    cell[a] = (lp, ("bin", k, b, c))
                self._unary_closure(cell)
                if not cell:
                    # glue: best-scoring split joined under X
                    best = None
                    for k in range(i + 1, j):
                        for b, (lp_b, _) in chart[i][k].items():
                            for c, (lp_c, _) in chart[k][j].items():
                                lp = lp_b + lp_c + _GLUE_LOGP
                                if best is None or lp > best[0]:
                                    best = (lp, ("bin", k, b, c))
                    if best is not None:
                        cell[GLUE] = best
                        self._unary_closure(cell)

        root_cell = chart[0][n]
        root = (self.grammar.start if self.grammar.start in root_cell
                else max(root_cell, key=lambda s: root_cell[s][0]))
        tree = self._build(chart, tokens, 0, n, root)
        tree.assign_spans()
        return tree

    # ------------------------------------------------------------------ internals
    def _unary_closure(self, cell):
        # iterate to fixpoint: updates strictly increase a cell entry's
        # log-prob and rule log-probs are <= 0, so termination is guaranteed
        # (a capped loop would silently truncate unary chains longer than
        # the cap in induced grammars)
        while True:
            changed = False
            for b, (lp_b, _) in list(cell.items()):
                for a, lp_rule in self.grammar.unary.get(b, ()):
                    lp = lp_b + lp_rule
                    if a not in cell or lp > cell[a][0]:
                        cell[a] = (lp, ("un", b))
                        changed = True
            if not changed:
                break

    def _build(self, chart, tokens, i, j, sym) -> Tree:
        _, back = chart[i][j][sym]
        if back[0] == "tag":
            # preterminal: tag node over the word leaf
            return Tree(label=sym, children=[Tree(word=tokens[i], label=sym)])
        if back[0] == "un":
            return Tree(label=sym, children=[self._build(chart, tokens, i, j,
                                                         back[1])])
        _, k, b, c = back
        return Tree(label=sym, children=[self._build(chart, tokens, i, k, b),
                                         self._build(chart, tokens, k, j, c)])
