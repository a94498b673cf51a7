"""Sentiment lexicon scoring.

Capability match of ``text/corpora/sentiwordnet/SWN3.java``: token-level
polarity lookup aggregated to a document judgment.  The reference ships the
SentiWordNet data file; redistribution isn't bundled here, so the loader
accepts the standard SWN tab-separated format from disk and falls back to a
small built-in seed lexicon for offline use.

Port of ``deeplearning4j_tpu/text/sentiwordnet.py``: host code, copied.
"""

from __future__ import annotations

from pathlib import Path

_SEED = {
    "good": 0.6, "great": 0.8, "excellent": 0.9, "love": 0.8, "happy": 0.7,
    "wonderful": 0.8, "best": 0.7, "nice": 0.5, "amazing": 0.8, "like": 0.3,
    "bad": -0.6, "terrible": -0.8, "awful": -0.8, "hate": -0.8, "sad": -0.6,
    "horrible": -0.8, "worst": -0.9, "poor": -0.5, "disappointing": -0.6,
    "boring": -0.5, "not": -0.2, "never": -0.2,
}


class SentiWordNet:
    def __init__(self, path: str | Path | None = None):
        self.scores: dict[str, float] = dict(_SEED)
        if path is not None:
            self._load_swn(Path(path))

    def _load_swn(self, path: Path) -> None:
        """Parse the standard SentiWordNet 3.0 TSV (POS\\tID\\tPosScore\\t
        NegScore\\tSynsetTerms\\tGloss)."""
        agg: dict[str, list[float]] = {}
        for line in path.read_text().splitlines():
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            if len(parts) < 5:
                continue
            try:
                pos_s, neg_s = float(parts[2]), float(parts[3])
            except ValueError:
                continue
            for term in parts[4].split():
                word = term.rsplit("#", 1)[0].lower()
                agg.setdefault(word, []).append(pos_s - neg_s)
        for w, vals in agg.items():
            self.scores[w] = sum(vals) / len(vals)

    def score(self, word: str) -> float:
        return self.scores.get(word.lower(), 0.0)

    def classify(self, tokens) -> str:
        """strong_positive/positive/neutral/negative/strong_negative
        (SWN3's judgment buckets)."""
        total = sum(self.score(t) for t in tokens)
        n = max(1, sum(1 for t in tokens if t.lower() in self.scores))
        avg = total / n
        if avg >= 0.5:
            return "strong_positive"
        if avg > 0.05:
            return "positive"
        if avg <= -0.5:
            return "strong_negative"
        if avg < -0.05:
            return "negative"
        return "neutral"
