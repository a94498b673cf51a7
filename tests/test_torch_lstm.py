"""The port's LSTM sequence model (``models.lstm``) against the JAX
package's, on the CPU.

The weights are the reference's ``init()`` draw, carried through numpy
(``models.convert``).  ``fit_sequence``'s losses over 20 epochs agree
within 1e-5; ``predict_next``, ``beam_search`` and ``sample(seed=1)``
give the same tokens (``sample`` draws from numpy's ``default_rng`` in
both packages); beam scores within 1e-5.  The reference's
``test_lstm_model_learns_and_beam_search`` holds as the port's own.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.lstm import LSTMSequenceModel as JLSTM
from deeplearning4j_tpu_torch.models.convert import (params_from_numpy,
                                                      params_to_numpy)
from deeplearning4j_tpu_torch.models.lstm import LSTMSequenceModel

CPU = "cpu"
SEQ = np.array([0, 1, 2, 3] * 10, np.int32)
TEXT = "abcdefg " * 12


def _pair(vocab=4, hidden=24, lr=0.3, seed=0):
    j = JLSTM(vocab_size=vocab, hidden_size=hidden, lr=lr, seed=seed)
    j.init()
    t = LSTMSequenceModel(vocab_size=vocab, hidden_size=hidden, lr=lr,
                          seed=seed, device=CPU)
    t.params = params_from_numpy(
        {k: np.asarray(v) for k, v in j.params.items()}, device=CPU)
    return t, j


def _text_tokens():
    chars = sorted(set(TEXT))
    idx = {c: i for i, c in enumerate(chars)}
    return np.array([idx[c] for c in TEXT], np.int32), len(chars)


@pytest.mark.parametrize("case", ["cycle4", "text"])
def test_fit_losses_and_params_equal_the_reference(case):
    if case == "cycle4":
        t, j = _pair()
        seq = SEQ
    else:
        seq, v = _text_tokens()
        t, j = _pair(vocab=v, hidden=16, lr=0.1, seed=3)
    lt = t.fit_sequence(seq, epochs=20)
    lj = j.fit_sequence(seq, epochs=20)
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    assert lt[-1] < lt[0]
    for k, v in j.params.items():
        np.testing.assert_allclose(t.params[k].numpy(), np.asarray(v),
                                   atol=1e-5)


def test_decoding_equals_the_reference():
    t, j = _pair()
    t.fit_sequence(SEQ, epochs=30)
    j.fit_sequence(SEQ, epochs=30)
    for prime in ([0, 1, 2], [3], [], [2, 2, 0]):
        assert t.predict_next(prime) == j.predict_next(prime), prime
    for prime, length, width in (([0, 1], 4, 3), ([2], 6, 2), ([], 3, 4)):
        ts, tscore = t.beam_search(prime, length, width)
        js, jscore = j.beam_search(prime, length, width)
        assert ts == js and abs(tscore - jscore) < 1e-5
    for seed, temp in ((1, 0.3), (4, 1.0), (7, 2.0)):
        assert t.sample([0], 8, temperature=temp, seed=seed) == \
            j.sample([0], 8, temperature=temp, seed=seed)


def test_default_init_is_a_cpu_generator_draw():
    a = LSTMSequenceModel(5, 8, seed=3, device=CPU).init()
    b = LSTMSequenceModel(5, 8, seed=3, device=CPU).init()
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = LSTMSequenceModel(5, 8, seed=3, device=CPU).init(
        torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], c[k]) for k in a)
    assert set(a) == set(params_to_numpy(a)) == {
        "recurrentweights", "decoderweights", "decoderbias"}
    assert a["recurrentweights"].shape == (1 + 5 + 8, 4 * 8)


def test_lstm_model_learns_and_beam_search():
    """The reference's test (tests/test_models_utils.py), on the port."""
    model = LSTMSequenceModel(vocab_size=4, hidden_size=24, lr=0.3,
                              device=CPU)
    model.init()
    losses = model.fit_sequence(SEQ, epochs=120)
    assert losses[-1] < losses[0] * 0.4
    assert model.predict_next([0, 1, 2]) == 3
    decoded, score = model.beam_search([0, 1], length=4, beam_width=3)
    assert decoded[2:] == [2, 3, 0, 1]
    sampled = model.sample([0], length=5, temperature=0.3, seed=1)
    assert len(sampled) == 6


def test_lstm_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LSTMSequenceModel(4, 8)
