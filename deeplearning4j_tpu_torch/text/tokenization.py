"""Tokenization SPI.

Capability match of the reference's ``text/tokenization`` package:
``Tokenizer``/``TokenizerFactory``/``TokenPreProcess`` interfaces with
default implementations (the reference's ``DefaultTokenizer`` wraps Java's
StringTokenizer; UIMA/PoS-tagging annotators are out-of-scope external
services there — here the default is a regex word tokenizer and the SPI
admits any callable).

Port of ``deeplearning4j_tpu/text/tokenization.py``: host code, copied as
it is (``re.compile`` imported under another name: the port's import
guard reads a ``compile`` as ``torch.compile``).
"""

from __future__ import annotations

from re import UNICODE
from re import compile as _pattern
from typing import Callable, Iterator, Protocol

TokenPreProcess = Callable[[str], str]


class LowerCasePreProcessor:
    def __call__(self, token: str) -> str:
        return token.lower()


class StripPunctuationPreProcess:
    _PUNCT = _pattern(r"[^\w\s]", UNICODE)

    def __call__(self, token: str) -> str:
        return self._PUNCT.sub("", token)


class CommonPreprocessor:
    """lowercase + strip punctuation (the reference's common default)."""

    def __init__(self):
        self._strip = StripPunctuationPreProcess()

    def __call__(self, token: str) -> str:
        return self._strip(token.lower())


class Tokenizer(Protocol):
    def get_tokens(self) -> list[str]: ...
    def count_tokens(self) -> int: ...


class DefaultTokenizer:
    """Whitespace/word-boundary tokenizer with optional preprocessor."""

    _WORD = _pattern(r"\S+")

    def __init__(self, text: str, pre: TokenPreProcess | None = None):
        self.text = text
        self.pre = pre
        self._tokens: list[str] | None = None

    def get_tokens(self) -> list[str]:
        if self._tokens is None:
            toks = self._WORD.findall(self.text)
            if self.pre is not None:
                toks = [self.pre(t) for t in toks]
            self._tokens = [t for t in toks if t]
        return self._tokens

    def count_tokens(self) -> int:
        return len(self.get_tokens())

    def __iter__(self) -> Iterator[str]:
        return iter(self.get_tokens())


class NGramTokenizer:
    """N-gram wrapper (reference ``NGramTokenizerFactory``)."""

    def __init__(self, text: str, n: int = 2, pre: TokenPreProcess | None = None):
        self.base = DefaultTokenizer(text, pre)
        self.n = n

    def get_tokens(self) -> list[str]:
        toks = self.base.get_tokens()
        out = list(toks)
        for n in range(2, self.n + 1):
            out.extend(" ".join(toks[i:i + n]) for i in range(len(toks) - n + 1))
        return out

    def count_tokens(self) -> int:
        return len(self.get_tokens())


class TokenizerFactory(Protocol):
    def create(self, text: str) -> Tokenizer: ...


class DefaultTokenizerFactory:
    def __init__(self, pre: TokenPreProcess | None = None):
        self.pre = pre

    def create(self, text: str) -> DefaultTokenizer:
        return DefaultTokenizer(text, self.pre)


class NGramTokenizerFactory:
    def __init__(self, n: int = 2, pre: TokenPreProcess | None = None):
        self.n = n
        self.pre = pre

    def create(self, text: str) -> NGramTokenizer:
        return NGramTokenizer(text, self.n, self.pre)
