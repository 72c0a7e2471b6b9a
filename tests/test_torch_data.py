"""The port's synthetic data (``repro_torch.data``) against the JAX
package's: the same arrays for the same seeds from
``make_classification_dataset``, ``weak_labels`` and ``lm_batch``, and the
same batches from ``BatchIterator`` (on the CPU device here), exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import data as jdata  # noqa: E402
from repro_torch import data  # noqa: E402


@pytest.mark.parametrize("noise,seed", [(0.0, 0), (0.4, 3)])
def test_classification_dataset_matches_jax(noise, seed):
    jc = jdata.ClassificationConfig(num_classes=4, vocab_size=512, seq_len=32, seed=1)
    tc = data.ClassificationConfig(num_classes=4, vocab_size=512, seq_len=32, seed=1)
    want = jdata.make_classification_dataset(jc, 96, noise=noise, seed=seed)
    got = data.make_classification_dataset(tc, 96, noise=noise, seed=seed)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("lf_accuracy", [0.5, 0.7])
def test_weak_labels_match_jax(lf_accuracy):
    y = np.random.default_rng(0).integers(0, 4, size=200).astype(np.int32)
    want = jdata.weak_labels(y, 4, num_lfs=5, lf_accuracy=lf_accuracy, seed=2)
    got = data.weak_labels(y, 4, num_lfs=5, lf_accuracy=lf_accuracy, seed=2)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab,seq", [(512, 16), (30_522, 128)])
def test_lm_batch_matches_jax(vocab, seq):
    want = jdata.lm_batch(jdata.LMStreamConfig(vocab_size=vocab, seq_len=seq),
                          np.random.default_rng(7), 6)
    got = data.lm_batch(data.LMStreamConfig(vocab_size=vocab, seq_len=seq),
                        np.random.default_rng(7), 6)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["tokens"].dtype == np.int32


def test_batch_iterator_matches_jax():
    cfg = data.ClassificationConfig(num_classes=4, vocab_size=128, seq_len=8)
    train = data.make_classification_dataset(cfg, 50, noise=0.3, seed=0)
    meta = data.make_classification_dataset(cfg, 20, seed=1)
    jit = jdata.BatchIterator(train, meta, batch_size=6, meta_batch_size=4, unroll=2, seed=5)
    tit = data.BatchIterator(train, meta, batch_size=6, meta_batch_size=4, unroll=2, seed=5,
                             device="cpu")
    for _ in range(3):
        (jb, jm), (tb, tm) = next(jit), next(tit)
        for want, got in ((jb, tb), (jm, tm)):
            assert sorted(got) == ["tokens", "y"]
            for key in want:
                assert got[key].device.type == "cpu" and got[key].dtype == torch.int32
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert tuple(tb["tokens"].shape) == (2, 6, 8) and tuple(tm["y"].shape) == (4,)
