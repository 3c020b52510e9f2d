"""The port's sentence evaluation — the causal word LM, its training, the
scorers and the beam search — and its pure-Python copies (phonetics,
manifest), against the JAX package on the same inputs and weights (Flax
params bridged by ``models.convert.word_lm_state_dict_from_flax``)."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.data import manifest as jman
from lipreading_video_generation_tpu.models import word_lm as jlm
from lipreading_video_generation_tpu.pipelines import phonetics as jph
from lipreading_video_generation_tpu.pipelines import sentence_eval as jse
from lipreading_video_generation_tpu_torch.data import manifest as tman
from lipreading_video_generation_tpu_torch.models import word_lm as tlm
from lipreading_video_generation_tpu_torch.models.convert import word_lm_state_dict_from_flax
from lipreading_video_generation_tpu_torch.ops import attention as tatt
from lipreading_video_generation_tpu_torch.pipelines import phonetics as tph
from lipreading_video_generation_tpu_torch.pipelines import sentence_eval as tse

WORDS = ["THE", "CAT", "DOG", "SAT", "RAN", "ON", "A", "MAT", "IN", "PARK", "BIG", "RED"]
SENTENCES = ["the cat sat on the mat", "the dog ran in the park", "a big dog sat",
             "the red cat ran", "a cat sat in a park", "the big red dog ran on the mat",
             "a dog sat on a mat", "the cat ran in the park", "red dog", "big cat sat"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _flax_lm(vocab_size, seed=0, max_len=32):
    model = jlm.WordLM(vocab_size=vocab_size, max_len=max_len)
    params = model.init(jax.random.key(seed), jnp.zeros((1, max_len - 1), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_lm(params, vocab_size, max_len=32):
    model = tlm.WordLM(vocab_size, max_len=max_len).eval()
    model.load_state_dict(word_lm_state_dict_from_flax(params))
    return model


def _close_trees(got: torch.nn.Module, want_params, atol, noise_bound=None):
    """Every param within ``atol``; with ``noise_bound``, the key third of
    each qkv bias (its gradient is 0 in exact arithmetic: adding a constant
    to every key's score leaves the softmax as it is, so Adam steps on
    float32 noise there) only within ``noise_bound``."""
    want = word_lm_state_dict_from_flax(want_params)
    got = got.state_dict()
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if noise_bound is not None and k.startswith("qkv_") and k.endswith(".bias"):
            e = len(w) // 3
            np.testing.assert_allclose(g[e:2 * e], w[e:2 * e], rtol=0, atol=noise_bound, err_msg=k)
            g, w = np.delete(g, np.s_[e:2 * e]), np.delete(w, np.s_[e:2 * e])
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


def test_word_lm_logits_and_likelihood_match_jax():
    """Logits and ``sequence_log_likelihood`` within 1e-5 (float32; the
    causal attention is ``_mha_einsum`` on both sides at these shapes)."""
    vocab = jlm.build_word_vocab(SENTENCES)
    assert tlm.build_word_vocab(SENTENCES) == vocab
    toks = jlm.encode_sentences(SENTENCES, vocab, 32)
    np.testing.assert_array_equal(tlm.encode_sentences(SENTENCES, vocab, 32), toks)
    jmodel, params = _flax_lm(len(vocab))
    model = _port_lm(params, len(vocab))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(toks[:, :-1])))
    launches = tatt.small_mha.launch_count
    with torch.no_grad():
        got = model(torch.from_numpy(toks[:, :-1])).numpy()
        ll = tlm.sequence_log_likelihood(model, torch.from_numpy(toks)).numpy()
    assert got.shape == (len(SENTENCES), 31, len(vocab))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    want_ll = np.asarray(jlm.sequence_log_likelihood(params, jmodel, jnp.asarray(toks)))
    np.testing.assert_allclose(ll, want_ll, rtol=0, atol=1e-5)
    assert tatt.small_mha.launch_count == launches    # no kernel off the card


def test_word_lm_is_causal():
    """A token's logits do not depend on later tokens."""
    vocab = tlm.build_word_vocab(SENTENCES)
    model = tlm.WordLM(len(vocab)).eval()
    toks = torch.from_numpy(tlm.encode_sentences(SENTENCES[:2], vocab, 32))
    other = toks.clone()
    other[:, 5:] = 7
    with torch.no_grad():
        a, b = model(toks[:, :-1]), model(other[:, :-1])
    torch.testing.assert_close(a[:, :5], b[:, :5], rtol=0, atol=0)
    assert not torch.equal(a[:, 5:], b[:, 5:])


def test_train_word_lm_matches_jax():
    """A few Adam steps from the same initial params on the same numpy batch
    picks (``np.random.default_rng(seed)``): params within 1e-4, the key
    third of the qkv biases (zero gradient, Adam on float32 noise) within
    2·lr a step. (JAX's ``train_word_lm`` inits from
    ``jax.random.key(seed)``; the port's ``fit_word_lm`` is its training
    loop, here started from those params.)"""
    steps, seed = 4, 0
    vocab = jlm.build_word_vocab(SENTENCES)
    params_j, vocab_j, _ = jlm.train_word_lm(SENTENCES, steps=steps, batch_size=6, seed=seed)
    assert vocab_j == vocab
    _, init = _flax_lm(len(vocab), seed)
    model = _port_lm(init, len(vocab))
    out = tlm.fit_word_lm(model, tlm.encode_sentences(SENTENCES, vocab, 32), steps=steps,
                          batch_size=6, seed=seed)
    assert out is model and not model.training
    _close_trees(model, jax.tree_util.tree_map(np.asarray, params_j), atol=1e-4,
                 noise_bound=2 * 3e-3 * steps)
    port_model, port_vocab = tlm.train_word_lm(SENTENCES, steps=1, device="cpu")
    assert port_vocab == vocab and isinstance(port_model, tlm.WordLM)


def _bridged_scorers(steps=20):
    """A JAX ``NeuralScorer`` trained on ``SENTENCES`` and the port's on its
    weights and vocab."""
    jscorer = jse.NeuralScorer(steps=steps).fit(SENTENCES)
    params = jax.tree_util.tree_map(np.asarray, jscorer.params)
    tscorer = tse.NeuralScorer(steps=steps, device="cpu")
    tscorer.model, tscorer.vocab = _port_lm(params, len(jscorer.vocab)), jscorer.vocab
    return jscorer, tscorer


def _beam_inputs(rng, n_sent=4):
    vocab_list = ["[UNK]"] + WORDS
    lengths = rng.integers(2, 5, n_sent)
    starts = list(np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(int))
    n = int(lengths.sum())
    labels = rng.integers(1, len(vocab_list), n)
    logp = rng.normal(-3.0, 1.0, (n, len(vocab_list)))
    logp[np.arange(n), labels] += rng.uniform(0.0, 3.0, n)
    return logp, labels, starts, vocab_list


def test_evaluate_sentences_with_neural_scorer_matches_jax(monkeypatch):
    """The same log-probs and a bridged scorer: every beam level's scores
    within 1e-5, the same candidate lists and the same accuracy."""
    jscorer, tscorer = _bridged_scorers()
    rng = np.random.default_rng(0)
    logp, labels, starts, vocab_list = _beam_inputs(rng)
    level = [f"{a} {b}" for a in WORDS for b in WORDS[:6]]
    np.testing.assert_allclose(tscorer.score_batch(level), jscorer.score_batch(level),
                               rtol=0, atol=1e-5)
    beams = {}
    for mod, scorer in ((jse, jscorer), (tse, tscorer)):
        real = mod.beam_search
        found = []

        def recording(*args, _real=real, _found=found, **kwargs):
            out = _real(*args, **kwargs)
            _found.append(out)
            return out

        monkeypatch.setattr(mod, "beam_search", recording)
        acc = mod.evaluate_sentences(logp, labels, starts, vocab_list, scorer)
        beams[mod.__name__] = (found, acc)
    (want, want_acc), (got, got_acc) = beams[jse.__name__], beams[tse.__name__]
    assert len(got) == len(starts) and got == want and got_acc == want_acc


def test_ngram_scorer_and_beam_search_match_jax(monkeypatch):
    """The bigram scorer's scores equal, and beam search over it gives the
    same candidates; ``fit_default_scorer`` takes the bigram below 8
    transcripts and the neural scorer (its training stubbed here) from 8 on,
    empty transcripts not counted."""
    jng, tng = jse.NgramScorer().fit(SENTENCES), tse.NgramScorer().fit(SENTENCES)
    for s in SENTENCES + ["mat the on", "unknown words here", ""]:
        assert tng(s) == jng(s)
    possible = [["THE", "A", "RED"], ["CAT", "DOG", "MAT"], ["SAT", "RAN", "ON"]]
    assert tse.beam_search(tng, possible, 4, 3) == jse.beam_search(jng, possible, 4, 3)
    assert tse.beam_search(tng, []) == []
    fitted = []
    monkeypatch.setattr(tse.NeuralScorer, "fit", lambda self, s: fitted.append(s) or self)
    assert isinstance(tse.fit_default_scorer(SENTENCES[:7] + [""], device="cpu"),
                      tse.NgramScorer)
    scorer = tse.fit_default_scorer(SENTENCES[:8] + ["", " "], seed=1, device="cpu")
    assert isinstance(scorer, tse.NeuralScorer) and scorer.seed == 1
    assert fitted == [SENTENCES[:8]]


def test_phonetics_match_jax():
    words = WORDS + ["ROBERT", "RUPERT", "ASHCRAFT", "TYMCZAK", "PFISTER", "HONEYMAN", "", "X"]
    assert [tph.soundex(w) for w in words] == [jph.soundex(w) for w in words]
    assert tph.create_phonetics(WORDS) == jph.create_phonetics(WORDS)
    p2l, _, w2p, _ = tph.create_phonetics(WORDS)
    assert (tph.word_labels_to_phonetic_labels([0, 3, 5, 11], WORDS, w2p, p2l)
            == jph.word_labels_to_phonetic_labels([0, 3, 5, 11], WORDS, w2p, p2l))


def test_manifest_matches_jax(tmp_path):
    """Transcripts, manifests (walked and by filelist, a missing video, a
    missing or broken transcript), vocab and word windows equal."""
    for i, (spk, text) in enumerate([("a", "HELLO WORLD"), ("b", "AGAIN THERE"),
                                     ("c", "NO VIDEO")]):
        d = tmp_path / spk
        d.mkdir()
        if spk != "c":
            (d / "00001.mp4").write_bytes(b"")
        words = text.split()
        (d / "00001.txt").write_text(
            f"Text:  {text}\n\nConf: 4\n\nWORD START END SCORE\n"
            + "".join(f"{w} {0.3 * j:.2f} {0.3 * j + 0.27:.2f} 1.0\n" for j, w in enumerate(words))
            + "BROKEN x y\n")
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "00001.mp4").write_bytes(b"")          # no transcript
    (tmp_path / "list.txt").write_text("a/00001\n\nb/00001\nc/00001\n")
    root = str(tmp_path)
    assert tman.read_filelist(root + "/list.txt") == jman.read_filelist(root + "/list.txt")
    (text, spans), (jtext, jspans) = (m.parse_transcript(root + "/a/00001.txt")
                                      for m in (tman, jman))
    assert text == jtext and list(map(dataclasses.asdict, spans)) == list(
        map(dataclasses.asdict, jspans))
    for kw in ({}, {"require_transcript": True},
               {"filelist": jman.read_filelist(root + "/list.txt")}):
        got, want = tman.build_manifest(root, **kw), jman.build_manifest(root, **kw)
        assert got[1] == want[1]
        assert ([dataclasses.asdict(r) for r in got[0]]
                == [dataclasses.asdict(r) for r in want[0]])
    records = tman.build_manifest(root)[0]
    jrecords = jman.build_manifest(root)[0]
    assert tman.build_vocab(records) == jman.build_vocab(jrecords)
    assert [tman.word_windows(r) for r in records] == [jman.word_windows(r) for r in jrecords]
