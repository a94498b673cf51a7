"""Text annotators: POS tagging, stemming, sentence annotation.

Port of ``deeplearning4j_tpu/text/annotator.py``, host code, with its own
copy of the tagged sample (``data/pos_sample.txt``).  Capability parity
with the reference's UIMA annotator pipeline
(``deeplearning4j-nlp/src/main/java/
org/deeplearning4j/text/annotator/PoStagger.java``, ``StemmerAnnotator.java``,
``SentenceAnnotator.java``, ``TokenizerAnnotator.java``) — there those are
thin UIMA/CAS adapters over external OpenNLP models (a maxent POS model, a
Snowball stemmer, a sentence detector).  Here the annotators are
self-contained:

- :class:`AveragedPerceptronTagger` — trainable averaged-perceptron POS
  tagger (Collins 2002), greedy decode plus per-token score emission for
  Viterbi smoothing (``utils/viterbi.py``).  A vendored tagged sample
  (``data/pos_sample.txt``) trains a usable default offline (zero egress).
- :class:`PorterStemmer` / :class:`StemmerPreProcess` — the classic Porter
  (1980) algorithm as a ``TokenPreProcess``, pluggable anywhere the
  tokenization SPI accepts a preprocessor (≡ ``StemmerAnnotator``).
- :class:`SentenceAnnotator` — abbreviation-aware rule splitter
  (≡ ``SentenceAnnotator.java`` / OpenNLP sentence detector role).
- :class:`TokenizerAnnotator` — adapter from the tokenizer factory SPI to
  the annotator interface (≡ ``TokenizerAnnotator.java``).

Feeds ``text/windows.py`` (labeled context windows) and
``utils/viterbi.py`` (sequence smoothing), which previously had no
upstream tagger.
"""

from __future__ import annotations

import random
import re
from collections import defaultdict
from pathlib import Path

import numpy as np

_DATA = Path(__file__).parent / "data"


# --------------------------------------------------------------------------- stemmer

class PorterStemmer:
    """Porter (1980) suffix-stripping stemmer, implemented from the
    published algorithm description."""

    _VOWELS = set("aeiou")

    def _cons(self, w, i):
        c = w[i]
        if c in self._VOWELS:
            return False
        if c == "y":
            return i == 0 or not self._cons(w, i - 1)
        return True

    def _measure(self, stem):
        """m = number of VC sequences in [C](VC)^m[V]."""
        forms = "".join("c" if self._cons(stem, i) else "v"
                        for i in range(len(stem)))
        return len(re.findall("vc", forms))

    def _has_vowel(self, stem):
        return any(not self._cons(stem, i) for i in range(len(stem)))

    def _double_cons(self, w):
        return (len(w) >= 2 and w[-1] == w[-2] and self._cons(w, len(w) - 1))

    def _cvc(self, w):
        return (len(w) >= 3 and self._cons(w, len(w) - 3)
                and not self._cons(w, len(w) - 2)
                and self._cons(w, len(w) - 1) and w[-1] not in "wxy")

    def _replace(self, w, suf, rep, m_min=0):
        if w.endswith(suf):
            stem = w[: len(w) - len(suf)]
            if self._measure(stem) > m_min:
                return stem + rep, True
            return w, True        # matched but condition failed: stop here
        return w, False

    def stem(self, word: str) -> str:
        w = word.lower()
        if len(w) <= 2:
            return w
        # step 1a
        for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", "")):
            if w.endswith(suf):
                w = w[: len(w) - len(suf)] + rep
                break
        # step 1b
        if w.endswith("eed"):
            if self._measure(w[:-3]) > 0:
                w = w[:-1]
        else:
            flag = False
            for suf in ("ed", "ing"):
                if w.endswith(suf) and self._has_vowel(w[: len(w) - len(suf)]):
                    w = w[: len(w) - len(suf)]
                    flag = True
                    break
            if flag:
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif self._double_cons(w) and w[-1] not in "lsz":
                    w = w[:-1]
                elif self._measure(w) == 1 and self._cvc(w):
                    w += "e"
        # step 1c
        if w.endswith("y") and self._has_vowel(w[:-1]):
            w = w[:-1] + "i"
        # step 2
        for suf, rep in (("ational", "ate"), ("tional", "tion"),
                         ("enci", "ence"), ("anci", "ance"), ("izer", "ize"),
                         ("abli", "able"), ("alli", "al"), ("entli", "ent"),
                         ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
                         ("ation", "ate"), ("ator", "ate"), ("alism", "al"),
                         ("iveness", "ive"), ("fulness", "ful"),
                         ("ousness", "ous"), ("aliti", "al"),
                         ("iviti", "ive"), ("biliti", "ble")):
            nw, matched = self._replace(w, suf, rep)
            if matched:
                w = nw
                break
        # step 3
        for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                         ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                         ("ness", "")):
            nw, matched = self._replace(w, suf, rep)
            if matched:
                w = nw
                break
        # step 4
        for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                    "ement", "ment", "ent", "ou", "ism", "ate", "iti",
                    "ous", "ive", "ize"):
            if w.endswith(suf):
                if self._measure(w[: len(w) - len(suf)]) > 1:
                    w = w[: len(w) - len(suf)]
                break
        else:
            if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                    and self._measure(w[:-3]) > 1:
                w = w[:-3]
        # step 5a
        if w.endswith("e"):
            stem = w[:-1]
            m = self._measure(stem)
            if m > 1 or (m == 1 and not self._cvc(stem)):
                w = stem
        # step 5b
        if self._double_cons(w) and w.endswith("l") and self._measure(w) > 1:
            w = w[:-1]
        return w


class StemmerPreProcess:
    """``TokenPreProcess`` that stems (≡ ``StemmerAnnotator.java`` wrapping
    the Snowball stemmer as a CAS annotator) — drop into any tokenizer
    factory: ``DefaultTokenizerFactory(pre=StemmerPreProcess())``."""

    def __init__(self, stemmer: PorterStemmer | None = None, lower=True):
        self.stemmer = stemmer or PorterStemmer()
        self.lower = lower

    def __call__(self, token: str) -> str:
        return self.stemmer.stem(token.lower() if self.lower else token)


# --------------------------------------------------------------------------- sentences

class SentenceAnnotator:
    """Abbreviation-aware sentence boundary splitter (the reference's
    ``SentenceAnnotator.java`` fills this role via OpenNLP's detector)."""

    # titles precede a (capitalized) name and never end a sentence; other
    # abbreviations CAN end one — for those, split iff the next word is
    # capitalized (the standard detector heuristic)
    _TITLES = {"mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st"}
    _ABBREV = {"vs", "etc", "inc", "ltd", "co", "e.g", "i.e", "u.s",
               "a.m", "p.m"}
    _BOUNDARY = re.compile(r"([.!?]+)(\s+|$)")

    def annotate(self, text: str) -> list[str]:
        sentences, start = [], 0
        for m in self._BOUNDARY.finditer(text):
            prev = text[start:m.end(1)]
            last_word = prev.rstrip(".!?").rsplit(None, 1)
            token = last_word[-1].lower().rstrip(".") if last_word else ""
            nxt = text[m.end():m.end() + 1]
            if token in self._TITLES:
                continue                     # never a boundary
            if token in self._ABBREV and not nxt.isupper():
                continue                     # mid-sentence abbreviation
            s = text[start:m.end(1)].strip()
            if s:
                sentences.append(s)
            start = m.end()
        tail = text[start:].strip()
        if tail:
            sentences.append(tail)
        return sentences

    __call__ = annotate


class TokenizerAnnotator:
    """Adapter: tokenizer-factory SPI -> annotator interface
    (≡ ``TokenizerAnnotator.java``)."""

    def __init__(self, factory=None):
        if factory is None:
            from .tokenization import DefaultTokenizerFactory
            factory = DefaultTokenizerFactory()
        self.factory = factory

    def annotate(self, text: str) -> list[str]:
        return self.factory.create(text).get_tokens()

    __call__ = annotate


# --------------------------------------------------------------------------- POS tagger

def _normalize(word: str) -> str:
    if any(ch.isdigit() for ch in word):
        return "!DIGIT" if word.isdigit() else "!MIXEDDIGIT"
    return word.lower()


class AveragedPerceptronTagger:
    """Averaged-perceptron POS tagger (Collins 2002; the standard
    lightweight trainable tagger).  Plays the reference ``PoStagger.java``
    role without the external OpenNLP maxent model: train on any
    word/TAG-formatted corpus, or call :meth:`default` for one trained on
    the vendored sample."""

    START = ("-START-", "-START2-")

    def __init__(self):
        self.weights: dict[str, dict[str, float]] = {}
        self.classes: list[str] = []
        self.tagdict: dict[str, str] = {}     # unambiguous-word shortcut

    # -- features -------------------------------------------------------
    def _features(self, i, word, context, prev, prev2):
        w = context[i]
        feats = {
            "bias": 1.0,
            f"word={w}": 1.0,
            f"suf3={w[-3:]}": 1.0,
            f"suf2={w[-2:]}": 1.0,
            f"pre1={w[:1]}": 1.0,
            f"prevtag={prev}": 1.0,
            f"prev2tags={prev2}|{prev}": 1.0,
            f"prevtag+word={prev}|{w}": 1.0,
            f"prevword={context[i - 1]}": 1.0,
            f"prevsuf3={context[i - 1][-3:]}": 1.0,
            f"nextword={context[i + 1]}": 1.0,
            f"nextsuf3={context[i + 1][-3:]}": 1.0,
        }
        if word and word[0].isupper():
            feats["shape=cap"] = 1.0
        return feats

    def _score(self, feats):
        scores = defaultdict(float)
        for f, v in feats.items():
            if f in self.weights:
                for tag, w in self.weights[f].items():
                    scores[tag] += w * v
        return scores

    # -- inference ------------------------------------------------------
    def tag(self, tokens: list[str]) -> list[tuple[str, str]]:
        """Greedy left-to-right decode (the tagdict shortcuts unambiguous
        words exactly like the textbook implementation)."""
        prev, prev2 = self.START
        context = ([self.START[0], self.START[1]]
                   + [_normalize(t) for t in tokens] + ["-END-", "-END2-"])
        out = []
        for i, tok in enumerate(tokens):
            tag = self.tagdict.get(_normalize(tok))
            if tag is None:
                feats = self._features(i + 2, tok, context, prev, prev2)
                scores = self._score(feats)
                tag = max(self.classes,
                          key=lambda t: (scores.get(t, 0.0), t))
            out.append((tok, tag))
            prev2, prev = prev, tag
        return out

    def emissions(self, tokens: list[str]) -> np.ndarray:
        """(T, n_classes) softmax-normalized scores for Viterbi smoothing
        (``utils/viterbi.py``) — the greedy path's scores, exposed."""
        prev, prev2 = self.START
        context = ([self.START[0], self.START[1]]
                   + [_normalize(t) for t in tokens] + ["-END-", "-END2-"])
        probs = np.zeros((len(tokens), len(self.classes)))
        for i, tok in enumerate(tokens):
            fixed = self.tagdict.get(_normalize(tok))
            if fixed is not None:
                # tagdict words are never perceptron-trained (the trainer
                # shortcuts them exactly like tag() does): peak the
                # distribution on the dictionary tag instead of exposing
                # untrained scores
                j = self.classes.index(fixed)
                probs[i] = (1.0 - 0.95) / max(1, len(self.classes) - 1)
                probs[i, j] = 0.95
                probs[i] /= probs[i].sum()   # exact with 1 class, no-op else
            else:
                feats = self._features(i + 2, tok, context, prev, prev2)
                scores = self._score(feats)
                row = np.array([scores.get(t, 0.0) for t in self.classes])
                row = np.exp(row - row.max())
                probs[i] = row / row.sum()
            tag = self.classes[int(np.argmax(probs[i]))]
            prev2, prev = prev, tag
        return probs

    def annotate(self, text: str) -> list[tuple[str, str]]:
        from .tokenization import DefaultTokenizer
        return self.tag(DefaultTokenizer(text).get_tokens())

    # -- training -------------------------------------------------------
    def train(self, sentences: list[list[tuple[str, str]]],
              n_iter: int = 8, seed: int = 0) -> None:
        """Averaged-perceptron training on (word, tag) sentences."""
        self.classes = sorted({t for s in sentences for _, t in s})
        self._make_tagdict(sentences)
        totals: dict[tuple[str, str], float] = defaultdict(float)
        tstamps: dict[tuple[str, str], int] = defaultdict(int)
        instances = 0
        rng = random.Random(seed)
        sentences = list(sentences)
        for _ in range(n_iter):
            rng.shuffle(sentences)
            for sent in sentences:
                tokens = [w for w, _ in sent]
                context = ([self.START[0], self.START[1]]
                           + [_normalize(t) for t in tokens]
                           + ["-END-", "-END2-"])
                prev, prev2 = self.START
                for i, (tok, gold) in enumerate(sent):
                    guess = self.tagdict.get(_normalize(tok))
                    if guess is None:
                        feats = self._features(i + 2, tok, context, prev, prev2)
                        scores = self._score(feats)
                        guess = max(self.classes,
                                    key=lambda t: (scores.get(t, 0.0), t))
                        instances += 1
                        if guess != gold:
                            for f in feats:
                                fw = self.weights.setdefault(f, {})
                                for tag, delta in ((gold, 1.0), (guess, -1.0)):
                                    key = (f, tag)
                                    # lazy averaging bookkeeping
                                    totals[key] += ((instances - tstamps[key])
                                                    * fw.get(tag, 0.0))
                                    tstamps[key] = instances
                                    fw[tag] = fw.get(tag, 0.0) + delta
                    prev2, prev = prev, guess
        # average
        for f, fw in self.weights.items():
            for tag, w in list(fw.items()):
                key = (f, tag)
                total = totals[key] + (instances - tstamps[key]) * w
                fw[tag] = total / max(1, instances)

    def _make_tagdict(self, sentences, freq_thresh=5, ambiguity=0.99):
        counts: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        for sent in sentences:
            for w, t in sent:
                counts[_normalize(w)][t] += 1
        for w, tags in counts.items():
            tag, mode = max(tags.items(), key=lambda kv: kv[1])
            n = sum(tags.values())
            if n >= freq_thresh and mode / n >= ambiguity:
                self.tagdict[w] = tag

    # -- persistence / default model ------------------------------------
    @classmethod
    def default(cls) -> "AveragedPerceptronTagger":
        """Tagger trained on the vendored sample corpus (offline)."""
        tagger = cls()
        tagger.train(load_tagged_corpus(_DATA / "pos_sample.txt"))
        return tagger


def load_tagged_corpus(path) -> list[list[tuple[str, str]]]:
    """word/TAG format, one sentence per line."""
    sentences = []
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        pairs = []
        for item in line.split():
            word, _, tag = item.rpartition("/")
            pairs.append((word, tag))
        sentences.append(pairs)
    return sentences


def pos_tag_viterbi(tokens: list[str], tagger: AveragedPerceptronTagger,
                    transition_prob: float | None = None, *,
                    device=None) -> list[tuple[str, str]]:
    """Viterbi-smoothed tagging: the tagger's per-token emission scores
    decoded with ``utils.viterbi`` (the reference pipes PoS output into
    ``Viterbi.java`` the same way, via window labels).

    Default transitions are uniform: unlike the sticky window labels
    Viterbi smooths in the reference, POS tags rarely self-repeat, so a
    self-transition prior would hurt — pass ``transition_prob`` to bias.
    The recursion runs on ``device`` (the card by default)."""
    from ..utils.viterbi import Viterbi
    if transition_prob is None:
        transition_prob = 1.0 / max(1, len(tagger.classes))
    probs = tagger.emissions(tokens)
    labels = Viterbi(tagger.classes, transition_prob,
                     device=device).decode(probs)
    return list(zip(tokens, labels))


def tagged_windows(tokens: list[str], tagger: AveragedPerceptronTagger,
                   window_size: int = 5):
    """Labeled context windows: each window's label is the focus token's
    POS tag — the ``Windows``/``WindowConverter`` training-pair flow
    (``text/movingwindow/Windows.java:17``) with a real upstream tagger."""
    from .windows import windows as make_windows
    tags = (t for _, t in tagger.tag(tokens))
    return list(zip(make_windows(tokens, window_size), tags))
