"""L8 — NLP stack of the port (reference: ``deeplearning4j-nlp``).

Port of ``deeplearning4j_tpu/text``, name for name its ``__all__``.
Host side: tokenization, sentence/document iteration, vocab building,
Huffman coding, co-occurrence counting, serialization — plain Python
(with the port's native C++ host runtime where profiled).  Device side:
batched skip-gram / negative-sampling / GloVe updates as in-place
gathers and deterministic scatter-adds on the GPU — the per-pair BLAS
axpy loops of the reference's ``InMemoryLookupTable`` become one
scatter-add per batch.
"""

from .tokenization import (
    DefaultTokenizer,
    DefaultTokenizerFactory,
    LowerCasePreProcessor,
    StripPunctuationPreProcess,
)
from .sentence import (
    CollectionSentenceIterator,
    FileSentenceIterator,
    LabelAwareListSentenceIterator,
    LineSentenceIterator,
)
from .vocab import Huffman, VocabCache, VocabWord, build_vocab
from .lm_dataset import LMCorpus, LMTokenBatchIterator
from .word2vec import Word2Vec
from .serializer import load_txt, save_txt, load_google_binary, save_google_binary
from .glove import Glove
from .paragraph_vectors import ParagraphVectors
from .vectorizers import BagOfWordsVectorizer, TfidfVectorizer

__all__ = [
    "DefaultTokenizer", "DefaultTokenizerFactory", "LowerCasePreProcessor",
    "StripPunctuationPreProcess",
    "CollectionSentenceIterator", "FileSentenceIterator",
    "LabelAwareListSentenceIterator", "LineSentenceIterator",
    "Huffman", "VocabCache", "VocabWord", "build_vocab",
    "LMCorpus", "LMTokenBatchIterator",
    "Word2Vec", "Glove", "ParagraphVectors",
    "load_txt", "save_txt", "load_google_binary", "save_google_binary",
    "BagOfWordsVectorizer", "TfidfVectorizer",
]
