"""The port's tree/parser/annotator text tier and the RNTN on the CPU.

Each module against the JAX package's on the same numpy-seeded inputs:
Viterbi paths equal (ties included: the first state wins, as with
``jnp.argmax``) and scores within 1e-5 relative; windows, trees, the
SentiWordNet lexicon, the annotators and the default tagger (its weights
and tags), ``pos_tag_viterbi``, the treebank parser's trees and the
inverted index equal; the RNTN from the reference's ``init()`` carried
across by ``params_from_numpy``: ``linearize``'s arrays and the trees'
mutated gold labels equal, the node buffer and logits within 1e-5 of
their scale, the loss and every gradient of one batch within 1e-5
relative, one AdaGrad step from a shared state within 1e-5 of each
leaf's scale, predictions equal; and the reference tests' RNTN flows
(``test_subsystems.py``, ``test_treeparser.py``) as they are written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import rntn as JR
from deeplearning4j_tpu.text import annotator as JA
from deeplearning4j_tpu.text import index as JI
from deeplearning4j_tpu.text import sentiwordnet as JSW
from deeplearning4j_tpu.text import tree as JT
from deeplearning4j_tpu.text import treeparser as JP
from deeplearning4j_tpu.text import windows as JW
from deeplearning4j_tpu.utils import viterbi as JV
from deeplearning4j_tpu_torch.models import rntn as TR
from deeplearning4j_tpu_torch.models.convert import params_from_numpy
from deeplearning4j_tpu_torch.text import annotator as TA
from deeplearning4j_tpu_torch.text import index as TI
from deeplearning4j_tpu_torch.text import sentiwordnet as TSW
from deeplearning4j_tpu_torch.text import tree as TT
from deeplearning4j_tpu_torch.text import treeparser as TP
from deeplearning4j_tpu_torch.text import windows as TW
from deeplearning4j_tpu_torch.text.tokenization import DefaultTokenizerFactory
from deeplearning4j_tpu_torch.utils import viterbi as TV

CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------------------------------------------------- viterbi

@pytest.mark.parametrize("T,S,seed,with_init", [
    (1, 4, 0, False), (2, 3, 1, False), (9, 5, 2, True), (40, 12, 3, False),
    (17, 2, 4, True)])
def test_viterbi_decode_matches_reference(T, S, seed, with_init):
    rng = np.random.default_rng(seed)
    em = rng.normal(size=(T, S))
    tr = np.log(rng.dirichlet(np.ones(S), size=S))
    init = rng.normal(size=S) if with_init else None
    want_path, want = JV.viterbi_decode(em, tr, init)
    got_path, got = TV.viterbi_decode(em, tr, init, device=CPU)
    np.testing.assert_array_equal(got_path, want_path)
    assert got_path.dtype == np.int64
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("S", [2, 5])
def test_viterbi_ties_take_the_first_state(S):
    # every path scores the same: jnp.argmax and the port pick state 0
    em = np.zeros((6, S))
    tr = np.zeros((S, S))
    want_path, want = JV.viterbi_decode(em, tr)
    got_path, got = TV.viterbi_decode(em, tr, device=CPU)
    assert want_path.tolist() == [0] * 6
    np.testing.assert_array_equal(got_path, want_path)
    assert got == want == 0.0
    # a tie in the middle between states 1 and 3 only
    em = np.full((3, 4), -5.0)
    em[1, [1, 3]] = 0.0
    got_path, _ = TV.viterbi_decode(em, np.zeros((4, 4)), device=CPU)
    want_path, _ = JV.viterbi_decode(em, np.zeros((4, 4)))
    np.testing.assert_array_equal(got_path, want_path)
    assert got_path[1] == 1


@pytest.mark.parametrize("p", [0.8, 0.95, 0.3])
def test_viterbi_class_matches_reference(p):
    em = np.array([[0.9, 0.1], [0.8, 0.2], [0.45, 0.55], [0.1, 0.9]])
    if p == 0.8:
        # the reference test's case
        assert TV.Viterbi([0, 1], transition_prob=0.8,
                          device=CPU).decode(em) == [0, 0, 1, 1]
        path, _ = TV.viterbi_decode(np.log(em), np.log(
            np.array([[0.8, 0.2], [0.2, 0.8]])), device=CPU)
        assert path.tolist() == [0, 0, 1, 1]
    rng = np.random.default_rng(7)
    probs = rng.dirichlet(np.ones(3), size=30)
    labels = ["a", "b", "c"]
    assert TV.Viterbi(labels, p, device=CPU).decode(probs) == \
        JV.Viterbi(labels, p).decode(probs)
    np.testing.assert_array_equal(TV.Viterbi(labels, p, device=CPU)
                                  .transitions, JV.Viterbi(labels, p)
                                  .transitions)


# -------------------------------------------------------------- windows/trees

def test_windows_match_reference():
    toks = ["a", "b", "c", "d"]
    for size in (1, 3, 5):
        got = TW.windows(toks, size, labels=list("wxyz"))
        want = JW.windows(toks, size, labels=list("wxyz"))
        assert [(w.words, w.focus, w.label) for w in got] == \
            [(w.words, w.focus, w.label) for w in want]
    ws = TW.windows(["a", "b", "c"], window_size=3, labels=["x", "y", "z"])
    assert ws[0].words == [TW.PAD, "a", "b"] and ws[0].focus == "a"
    assert ws[2].label == "z" and list(ws[1]) == ["a", "b", "c"]
    with pytest.raises(AssertionError):
        TW.windows(toks, 4)
    # a lookup returning numpy rows (Word2Vec.get_word_vector's) or None
    table = {"a": np.array([1.0, 2.0], np.float32),
             "c": np.array([3.0, 4.0], np.float32)}
    got = TW.window_matrix(ws[1], table.get, 2)
    want = JW.window_matrix(JW.windows(["a", "b", "c"], 3)[1], table.get, 2)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [1.0, 2.0, 0.0, 0.0, 3.0, 4.0]


SEXPRS = ["(3 (2 nice) (1 (0 not) (2 movie)))",
          "(1 (0 a) (0 b) (0 c) (0 d))",
          "(4 (3 (3 (2 really)) (4 great)) (2 (2 film) (2 here)))",
          "(S (NP (DET the) (NOUN cat)) (VP (VERB sat)))",
          "(2 word)"]


@pytest.mark.parametrize("s", SEXPRS)
def test_trees_match_reference(s):
    got, want = TT.parse_sexpr(s), JT.parse_sexpr(s)
    assert got.to_sexpr() == want.to_sexpr() == str(got)
    assert got.words() == want.words()
    assert got.depth() == want.depth()
    assert [(t.label, t.gold_label, t.span()) for t in got.subtrees()] == \
        [(t.label, t.gold_label, t.span()) for t in want.subtrees()]
    gb, wb = TT.binarize(got), JT.binarize(want)
    assert gb.to_sexpr() == wb.to_sexpr()
    assert all(len(node.children) <= 2 for node in gb.subtrees())
    assert got.error_sum() == 0.0 and len(got.leaves()) == len(got.words())


def test_right_branching_matches_reference():
    rb = TT.right_branching(["x", "y", "z"], label=1)
    assert rb.words() == ["x", "y", "z"] and rb.gold_label == 1
    assert rb.to_sexpr() == JT.right_branching(["x", "y", "z"], 1).to_sexpr()
    assert [t.gold_label for t in rb.subtrees()] == [1] * 5


# ------------------------------------------------------------- sentiwordnet

def test_sentiwordnet_matches_reference(tmp_path):
    p = tmp_path / "swn.txt"
    p.write_text("# comment\na\t1\t0.75\t0.0\tsplendid#1 grand#2\tgloss\n"
                 "a\t2\t0.0\t0.5\tgrand#1\tgloss\nbad line\n"
                 "n\t3\tx\ty\tz#1\tg\n")
    for path in (None, p):
        got, want = TSW.SentiWordNet(path), JSW.SentiWordNet(path)
        assert got.scores == want.scores
        for toks in ("this is a good great movie", "terrible awful hate",
                     "splendid grand day", "a plain day", "not bad",
                     "never good", "excellent excellent", "poor nice"):
            assert got.classify(toks.split()) == want.classify(toks.split())
    swn = TSW.SentiWordNet()
    assert swn.classify("this is a good great movie".split()) in (
        "positive", "strong_positive")
    assert swn.classify("terrible awful hate".split()) == "strong_negative"
    assert TSW.SentiWordNet(p).score("splendid") == pytest.approx(0.75)


# ---------------------------------------------------------------- annotators

STEMS = ["caresses", "ponies", "cats", "feed", "agreed", "plastered",
         "motoring", "sing", "conflated", "troubled", "sized", "hopping",
         "falling", "hissing", "happy", "relational", "conditional",
         "vietnamization", "predication", "operator", "callousness",
         "formaliti", "triplicate", "formative", "formalize", "revival",
         "allowance", "inference", "airliner", "adjustment", "probate",
         "rate", "controll", "generalizations", "oscillators", "a", "by"]


def test_porter_stemmer_matches_reference():
    got = [TA.PorterStemmer().stem(w) for w in STEMS]
    assert got == [JA.PorterStemmer().stem(w) for w in STEMS]
    assert got[:3] == ["caress", "poni", "cat"]
    factory = DefaultTokenizerFactory(pre=TA.StemmerPreProcess())
    toks = factory.create("The horses were running happily").get_tokens()
    assert toks == ["the", "hors", "were", "run", "happili"]


@pytest.mark.parametrize("text", [
    "Dr. Smith arrived at 9 a.m. sharp. He greeted Mrs. Jones warmly! "
    "Did the meeting start on time? It did.",
    "no punctuation here", "One. Two? Three! etc. and so on. Inc. Done.",
    ""])
def test_sentence_and_tokenizer_annotators_match_reference(text):
    got = TA.SentenceAnnotator().annotate(text)
    assert got == JA.SentenceAnnotator()(text)
    assert TA.TokenizerAnnotator()(text) == JA.TokenizerAnnotator()(text)
    if text.startswith("Dr."):
        assert len(got) == 4 and got[3] == "It did."


@pytest.fixture(scope="module")
def taggers():
    return TA.AveragedPerceptronTagger.default(), \
        JA.AveragedPerceptronTagger.default()


TAG_SENTS = [["the", "dog", "barks", "loudly", "."],
             ["the", "misty", "meadow"],
             ["the", "small", "cat", "sleeps", "."],
             ["she", "quickly", "reads", "a", "long", "book", "about", "3",
              "old", "kings", "and", "queens", "."],
             ["happy", "children", "love", "the", "terrible", "zx9"]]


def test_default_tagger_matches_reference(taggers):
    got, want = taggers
    assert TA._DATA.parent.name == "text" and \
        "deeplearning4j_tpu_torch" in str(TA._DATA)
    assert TA._DATA / "pos_sample.txt" != JA._DATA / "pos_sample.txt"
    assert (TA._DATA / "pos_sample.txt").read_bytes() == \
        (JA._DATA / "pos_sample.txt").read_bytes()
    assert got.classes == want.classes and got.tagdict == want.tagdict
    assert got.weights == want.weights
    for toks in TAG_SENTS:
        assert got.tag(toks) == want.tag(toks)
        np.testing.assert_array_equal(got.emissions(toks),
                                      want.emissions(toks))
        assert got.annotate(" ".join(toks)) == want.annotate(" ".join(toks))
    tags = dict(got.tag(["the", "dog", "barks", "loudly", "."]))
    assert (tags["the"], tags["dog"], tags["barks"], tags["loudly"]) == (
        "DET", "NOUN", "VERB", "ADV")


@pytest.mark.parametrize("tp", [None, 0.9, 0.05])
def test_pos_tag_viterbi_and_windows_match_reference(taggers, tp):
    got, want = taggers
    for toks in TAG_SENTS:
        assert TA.pos_tag_viterbi(toks, got, tp, device=CPU) == \
            JA.pos_tag_viterbi(toks, want, tp)
    t = [w for w, _ in TA.pos_tag_viterbi(
        ["the", "small", "cat", "sleeps", "."], got, device=CPU)]
    assert [x for _, x in TA.pos_tag_viterbi(
        ["the", "small", "cat", "sleeps", "."], got, device=CPU)] == \
        ["DET", "ADJ", "NOUN", "VERB", "."] and len(t) == 5
    wins = TA.tagged_windows(["the", "quick", "fox", "jumps"], got, 3)
    ref = JA.tagged_windows(["the", "quick", "fox", "jumps"], want, 3)
    assert [(w.words, lab) for w, lab in wins] == \
        [(w.words, lab) for w, lab in ref]
    assert wins[0][1] == "DET" and wins[2] == (wins[2][0], "NOUN")


def test_tagger_training_matches_reference():
    corpus = TA.load_tagged_corpus(TA._DATA / "pos_sample.txt")
    assert corpus == JA.load_tagged_corpus(JA._DATA / "pos_sample.txt")
    got, want = TA.AveragedPerceptronTagger(), JA.AveragedPerceptronTagger()
    got.train(corpus[:-8], n_iter=4, seed=3)
    want.train(corpus[:-8], n_iter=4, seed=3)
    assert got.weights == want.weights and got.tagdict == want.tagdict
    right = total = 0
    for sent in corpus[-8:]:
        tags = got.tag([w for w, _ in sent])
        assert tags == want.tag([w for w, _ in sent])
        right += sum(g == gold for (_, g), (_, gold) in zip(tags, sent))
        total += len(sent)
    assert right / total >= 0.8


# ------------------------------------------------------------------- parser

@pytest.fixture(scope="module")
def parsers(taggers):
    return TP.TreebankParser(tagger=taggers[0]), \
        JP.TreebankParser(tagger=taggers[1])


PARSE_SENTS = [
    "the quick brown fox jumps over the lazy dog",
    "the dog sleeps on the mat", "over over the the and", "dog",
    "the quick fox jumps", "she reads a long book",
    "the happy children play in the warm park",
    "the angry dog barks at the stranger", "the broken clock stops"]


@pytest.mark.parametrize("sent", PARSE_SENTS)
def test_treebank_parser_matches_reference(parsers, sent):
    got, want = parsers
    g, w = got.parse_tokens(sent.split()), want.parse_tokens(sent.split())
    assert g.to_sexpr() == w.to_sexpr()
    assert [t.span() for t in g.subtrees()] == \
        [t.span() for t in w.subtrees()]
    assert sorted(g.words()) == sorted(sent.split())
    assert TT.binarize(g).to_sexpr() == JT.binarize(w).to_sexpr()


def test_parser_get_trees_and_grammar_match_reference(parsers):
    got, want = parsers
    text = "The cat sleeps. The dog barks loudly."
    g, w = got.get_trees(text), want.get_trees(text)
    assert [t.to_sexpr() for t in g] == [t.to_sexpr() for t in w]
    assert len(g) == 2 and all(t.label == "S" for t in g)
    pp = [t for t in got.parse_tokens(["the", "dog", "sleeps", "on", "the",
                                        "mat"]).subtrees() if t.label == "PP"]
    assert pp and pp[0].span() == (3, 6)
    dg, dw = TP.Grammar.default(), JP.Grammar.default()
    assert dict(dg.binary) == dict(dw.binary)
    assert dict(dg.unary) == dict(dw.unary)
    texts = ["the quick fox jumps", "she reads a long book",
             "the dog sleeps on the mat"]
    g2 = TP.Grammar.from_trees([got.parse_tokens(t.split()) for t in texts])
    w2 = JP.Grammar.from_trees([want.parse_tokens(t.split()) for t in texts])
    assert dict(g2.binary) == dict(w2.binary) and \
        dict(g2.unary) == dict(w2.unary)
    p2 = TP.TreebankParser(grammar=g2, tagger=got.tagger)
    for t in texts:
        t2 = p2.parse_tokens(t.split())
        assert t2.words() == t.split() and t2.label == "S"
    with pytest.raises(ValueError):
        got.parse_tokens([])


# -------------------------------------------------------------------- index

DOCS = ["the cat sat", "the dog ran", "a cat and a dog",
        "The Cat, the hat!", "dogs and cats and more cats", ""]


def test_inverted_index_matches_reference(tmp_path):
    got, want = TI.InvertedIndex(), JI.InvertedIndex()
    got.add_all(DOCS)
    want.add_all(DOCS)
    got.add_doc(["pre", "tokenized", "cat"], label="L")
    want.add_doc(["pre", "tokenized", "cat"], label="L")
    assert got.num_documents() == want.num_documents() == 7
    assert got.terms() == want.terms()
    for t in got.terms():
        assert got.documents_for(t) == want.documents_for(t)
        assert got.doc_frequency(t) == want.doc_frequency(t)
    assert got.documents_for("cat") == want.documents_for("cat")
    assert got.label(6) == "L" and got.document(6) == want.document(6)
    for q in ("cat", "the dog", "cats and dogs", "nothing", "a hat"):
        assert got.search(q) == want.search(q)
        assert got.search(q, n=2) == want.search(q, n=2)
    assert list(got.batch_iter(3)) == list(want.batch_iter(3))
    assert got.all_docs() == want.all_docs()
    # save/load round trip, each package reading the other's file
    got.save(tmp_path / "port" / "ix.jsonl.gz")
    want.save(tmp_path / "ref" / "ix.jsonl.gz")
    for path in (tmp_path / "port" / "ix.jsonl.gz",
                 tmp_path / "ref" / "ix.jsonl.gz"):
        back_t, back_j = TI.InvertedIndex.load(path), JI.InvertedIndex.load(path)
        assert back_t.all_docs() == back_j.all_docs() == got.all_docs()
        assert [back_t.label(i) for i in range(7)] == \
            [got.label(i) for i in range(7)]
        assert back_t.search("the cat") == got.search("the cat")
    assert (tmp_path / "port" / "ix.jsonl.gz").stat().st_size > 0


# --------------------------------------------------------------------- RNTN

RNTN_SEXPRS = [
    "(3 (2 nice) (1 (0 not) (2 movie)))",
    "(4 (3 (3 (2 really)) (4 great)) (2 (2 film) (2 here)))",
    "(1 (1 (0 awful) (2 plot)) (2 (2 and) (1 (2 long) (1 (0 boring) "
    "(2 scenes)))))",
    "(2 (2 (2 the) (2 cast)) (3 (2 is) (3 (3 fine) (2 (2 enough) "
    "(2 (2 (2 overall)))))))",
    "(0 (0 terrible) (1 (2 (2 zzz_unseen)) (0 ending)))",
    "(3 (3 good) (2 (2 (2 quiet)) (2 (2 small) (2 film))))",
]
D, C, NODES, L2 = 6, 5, 16, 1e-4


def _trees(T):
    trees = [T.binarize(T.parse_sexpr(s)) for s in RNTN_SEXPRS]
    # an unlabelled node: its label -1 is kept (not in the loss)
    trees[1].children[1].gold_label = -1
    return trees


@pytest.fixture
def rntn_pair():
    """A reference RNTN after ``init()`` and the port's on its parameters
    (vocab built from the same trees by each package)."""
    ref = JR.RNTN(layer_size=D, n_classes=C, max_nodes=NODES, seed=3)
    vocab_trees = _trees(JT)[:-1]
    ref.build_vocab(vocab_trees)
    ref.init()
    port = TR.RNTN(layer_size=D, n_classes=C, max_nodes=NODES, seed=3,
                   device=CPU)
    port.build_vocab(_trees(TT)[:-1])
    assert port.vocab.words() == ref.vocab.words()
    host = jax.tree_util.tree_map(np.asarray, ref.params)
    port.params = params_from_numpy(host, device=CPU)
    port._hist = {k: torch.zeros_like(p) for k, p in port.params.items()}
    return ref, port, host


def test_linearize_matches_reference_and_mutates_labels(rntn_pair):
    ref, port, _ = rntn_pair
    jt, tt = _trees(JT), _trees(TT)
    for a, b in zip(jt, tt):
        want = JR.linearize(a, ref.vocab, NODES)
        got = TR.linearize(b, port.vocab, NODES)
        for f in TR._FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype
        assert got.n_slots == NODES
        # the unary chains' children took their parents' labels
        assert [n.gold_label for n in b.subtrees()] == \
            [n.gold_label for n in a.subtrees()]
    assert TR.linearize(_trees(TT)[2], port.vocab, 4) is None
    assert JR.linearize(_trees(JT)[2], ref.vocab, 4) is None
    # the last tree is outside the vocab: its unseen words map to *UNK*
    arr = TR.linearize(_trees(TT)[5], port.vocab, NODES)
    assert port.vocab.index_of(TR.UNK) in arr.word[arr.is_leaf == 1]
    # mutation: a pre-terminal's leaf (label -1) took the tag's label
    t = TT.parse_sexpr("(3 (2 (1 word)) (4 other))")
    leaf = t.children[0].children[0].children[0]
    assert leaf.gold_label == -1
    TR.linearize(t, port.vocab, NODES)
    assert leaf.gold_label == 1


def _batch_both(ref, port, trees_j, trees_t):
    return ref._batch_arrays(trees_j), port._batch_arrays(trees_t)


def _ref_batch_loss(params, batch, l2):
    losses, counts = jax.vmap(
        lambda t: JR._tree_loss(params, t, D, C))(batch)
    data = jnp.sum(losses) / jnp.maximum(jnp.sum(counts), 1.0)
    reg = sum(jnp.sum(p * p) for n, p in params.items() if n != "bs")
    return data + 0.5 * l2 * reg


def test_rntn_forward_loss_and_grads_match_reference(rntn_pair):
    ref, port, _ = rntn_pair
    bj, bt = _batch_both(ref, port, _trees(JT), _trees(TT))
    for k in TR._FIELDS:
        np.testing.assert_array_equal(_np(bt[k]), np.asarray(bj[k]))
    buf_j = np.stack([np.asarray(JR._forward_tree(
        ref.params, {k: v[i] for k, v in bj.items()}, D))
        for i in range(len(RNTN_SEXPRS))])
    with torch.no_grad():
        buf_t = _np(TR._forward_trees(port.params, bt))
        logits_t = _np(TR._logits(port.params, TR._forward_trees(
            port.params, bt)))
    assert buf_t.shape == (len(RNTN_SEXPRS), NODES, D)
    assert _rel(buf_t, buf_j) < 1e-5
    logits_j = np.asarray(jnp.asarray(buf_j) @ ref.params["Ws"].T
                          + ref.params["bs"])
    assert _rel(logits_t, logits_j) < 1e-5
    want_loss, want_g = jax.value_and_grad(_ref_batch_loss)(
        ref.params, bj, L2)
    loss, g = TR._loss_and_grads(port.params, bt, L2)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert set(g) == set(want_g)
    for k in g:
        assert g[k].shape == tuple(want_g[k].shape)
        assert _rel(_np(g[k]), want_g[k]) < 1e-5, k


@pytest.mark.parametrize("adagrad", [True, False])
def test_rntn_step_from_a_shared_state_matches_reference(rntn_pair, adagrad):
    ref, port, host = rntn_pair
    ref.adagrad = port.adagrad = adagrad
    rng = np.random.default_rng(5)
    hist = {k: (rng.random(v.shape) * 1e-3).astype(np.float32)
            for k, v in host.items()}
    bj, bt = _batch_both(ref, port, _trees(JT)[:4], _trees(TT)[:4])
    p_j, h_j, loss_j = ref._build_step()(
        ref.params, {k: jnp.asarray(v) for k, v in hist.items()}, bj)
    p_t, h_t, loss_t = port._build_step()(
        port.params, params_from_numpy(hist, device=CPU), bt)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for k in p_j:
        assert _rel(_np(p_t[k]), p_j[k]) < 1e-5, k
        assert _rel(_np(h_t[k]), h_j[k]) < 1e-5, k


def test_rntn_predictions_match_reference(rntn_pair):
    ref, port, _ = rntn_pair
    for a, b in zip(_trees(JT), _trees(TT)):
        np.testing.assert_array_equal(port.predict_tree(b),
                                      ref.predict_tree(a))
        assert port.predict_root(b) == ref.predict_root(a)
    assert port.accuracy(_trees(TT)) == ref.accuracy(_trees(JT))
    with pytest.raises(ValueError, match="node budget"):
        small = TR.RNTN(layer_size=D, max_nodes=2, device=CPU)
        small.vocab, small.params = port.vocab, port.params
        small.predict_tree(_trees(TT)[2])


def test_rntn_fit_order_and_init():
    """``fit`` walks the reference's numpy permutation; ``init`` draws at
    the reference's scales from a generator seeded ``seed``."""
    trees = _trees(TT)
    m = TR.RNTN(layer_size=D, n_classes=C, max_nodes=NODES, seed=3,
                device=CPU)
    m.build_vocab(trees)
    p = m.init()
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "emb": (len(m.vocab), D), "W": (D, 2 * D + 1),
        "V": (D, 2 * D, 2 * D), "Ws": (C, D), "bs": (C,)}
    assert float(p["emb"].std()) == pytest.approx(0.1, rel=0.3)
    assert float(p["V"].std()) == pytest.approx(0.01, rel=0.1)
    assert not p["bs"].any()
    again = TR.RNTN(layer_size=D, n_classes=C, max_nodes=NODES, seed=3,
                    device=CPU)
    again.build_vocab(trees)
    for k, v in again.init().items():
        assert torch.equal(v, p[k])
    seen = []
    step = m._build_step()

    def spy(params, hist, batch):
        seen.append(_np(batch["word"]).copy())
        return step(params, hist, batch)

    m._step = spy
    losses = m.fit(trees, epochs=2, batch_size=4)
    assert len(losses) == 2 and all(np.isfinite(losses))
    rng = np.random.default_rng(3)
    want = []
    for _ in range(2):
        order = rng.permutation(len(trees))
        for off in range(0, len(trees), 4):
            want.append(np.stack([TR.linearize(trees[i], m.vocab, NODES).word
                                  for i in order[off:off + 4]]))
    assert len(seen) == len(want)
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a, b)


def test_rntn_learns_toy_sentiment():
    """``tests/test_subsystems.py``'s flow on the port."""
    pos = [TT.right_branching(f"this movie is good {w}".split(), label=1)
           for w in ["really", "very", "so", "quite"]]
    neg = [TT.right_branching(f"this movie is bad {w}".split(), label=0)
           for w in ["really", "very", "so", "quite"]]
    trees = pos + neg
    model = TR.RNTN(layer_size=12, n_classes=2, max_nodes=16, lr=0.1, seed=1,
                    device=CPU)
    losses = model.fit(trees, epochs=60, batch_size=8)
    assert losses[-1] < losses[0]
    assert model.accuracy(trees) >= 0.9
    preds = model.predict_tree(trees[0])
    assert preds.shape[0] == int(np.sum(
        TR.linearize(trees[0], model.vocab, 16).mask))


def test_rntn_trains_from_raw_sentences(parsers):
    """``tests/test_treeparser.py``'s flow on the port: RNTN sentiment
    from raw sentences through the parser."""
    parser = parsers[0]
    pos = ["the happy children play in the warm park",
           "she sings a happy song", "the kind teacher helps the children",
           "we eat sweet honey", "the gentle breeze cools the beach"]
    neg = ["the angry dog barks at the stranger",
           "dark clouds gather above the field", "the sad man walks alone",
           "rain falls on the cold town", "the broken clock stops"]
    trees = []
    for label, sents in ((1, pos), (0, neg)):
        for s in sents:
            t = TT.binarize(parser.parse_tokens(s.split()))
            t.gold_label = label
            trees.append(t)
    model = TR.RNTN(layer_size=8, n_classes=2, max_nodes=64, lr=0.1, seed=0,
                    device=CPU)
    losses = model.fit(trees, epochs=25)
    assert losses[-1] < losses[0], losses
    right = 0
    for t in trees:
        pred = model.predict_tree(t)
        right += int(pred[-1]) == t.gold_label
    assert right / len(trees) >= 0.8, f"{right}/{len(trees)}"


def test_rntn_float64_follows_its_parameters(rntn_pair):
    """A float64 parameter tree runs the whole step in float64 (the card
    phase's AdaGrad comparison runs so)."""
    _, port, host = rntn_pair
    p64 = params_from_numpy({k: v.astype(np.float64)
                             for k, v in host.items()}, device=CPU)
    bt = port._batch_arrays(_trees(TT))
    loss, g = TR._loss_and_grads(p64, bt, L2)
    assert loss.dtype == torch.float64
    assert all(v.dtype == torch.float64 for v in g.values())
    loss32, _ = TR._loss_and_grads(port.params, bt, L2)
    assert abs(float(loss) - float(loss32)) < 1e-5 * abs(float(loss))
