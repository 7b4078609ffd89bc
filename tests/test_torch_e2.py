"""The port's `e2` helpers (`CategoricalNaiveBayes`, `MarkovChain`,
`BinaryVectorizer`, `split_data`), numpy in both packages, against the
JAX package's on the same inputs, and the cases of `tests/test_e2.py`."""

import numpy as np
import pytest

from predictionio_tpu import e2 as je2
from predictionio_tpu_torch import e2

pytestmark = pytest.mark.torch

POINTS = [("spam", ("cheap", "pills")), ("spam", ("cheap", "watches")),
          ("ham", ("meeting", "notes")), ("ham", ("cheap", "notes"))]


def _points(pkg, rng=None, n=0):
    if rng is None:
        pts = POINTS
    else:
        labels, vals = ["a", "b", "c"], ["x", "y", "z", "w"]
        pts = [(labels[rng.randint(3)],
                tuple(vals[rng.randint(4)] for _ in range(3)))
               for _ in range(n)]
    return [pkg.LabeledPoint(lb, f) for lb, f in pts]


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_naive_bayes_equals_the_jax_package(seed):
    rng = None if seed is None else np.random.RandomState(seed)
    ours = e2.CategoricalNaiveBayes.train(_points(e2, rng, 40))
    rng = None if seed is None else np.random.RandomState(seed)
    theirs = je2.CategoricalNaiveBayes.train(_points(je2, rng, 40))
    assert ours.priors == theirs.priors
    assert ours.likelihoods == theirs.likelihoods
    width = len(next(iter(ours.likelihoods.values())))
    probes = [f for f in [("cheap", "pills"), ("meeting", "zzz"),
                          ("x", "y", "z"), ("w", "w", "q")]
              if len(f) == width]
    for f in probes:
        for lb in list(ours.priors) + ["nope"]:
            for default in (None, lambda lls: min(lls)):
                kw = {} if default is None else {
                    "default_likelihood": default}
                assert ours.log_score(e2.LabeledPoint(lb, f), **kw) == \
                    theirs.log_score(je2.LabeledPoint(lb, f), **kw)
        assert ours.predict(f) == theirs.predict(f)


def test_naive_bayes_cases():
    m = e2.CategoricalNaiveBayes.train(_points(e2))
    assert m.priors["spam"] == pytest.approx(np.log(0.5))
    assert m.likelihoods["ham"][0]["cheap"] == pytest.approx(np.log(0.5))
    assert m.log_score(e2.LabeledPoint("spam", ("cheap", "zzz"))) == \
        float("-inf")
    assert m.log_score(e2.LabeledPoint("eggs", ("cheap", "pills"))) is None
    assert m.predict(("cheap", "pills")) == "spam"
    assert m.predict(("meeting", "notes")) == "ham"
    with pytest.raises(ValueError):
        e2.CategoricalNaiveBayes.train([])


@pytest.mark.parametrize("top_n,seed", [(2, 0), (3, 1), (10, 2)])
def test_markov_chain_equals_the_jax_package(top_n, seed):
    rng = np.random.RandomState(seed)
    pairs = [(int(a), int(b)) for a, b in rng.randint(0, 6, (200, 2))]
    ours = e2.MarkovChain.train(pairs, n_states=7, top_n=top_n)
    theirs = je2.MarkovChain.train(pairs, n_states=7, top_n=top_n)
    assert ours.transitions == theirs.transitions
    assert [ours.predict(s) for s in range(7)] == [
        theirs.predict(s) for s in range(7)]


def test_markov_chain_case():
    pairs = [(0, 1)] * 6 + [(0, 2)] * 3 + [(0, 3)] * 1 + [(1, 0)] * 2
    m = e2.MarkovChain.train(pairs, n_states=4, top_n=2)
    assert dict(m.predict(0)) == {1: 0.6, 2: 0.3}
    assert m.predict(1) == [(0, 1.0)] and m.predict(3) == []


@pytest.mark.parametrize("props", [["color", "size"], ["size"], []])
def test_binary_vectorizer_equals_the_jax_package(props):
    maps = [{"color": "red", "size": "L"}, {"color": "blue", "size": "L"},
            {"color": "red"}, {"shape": "round", "size": "S"}]
    ours, theirs = (e2.BinaryVectorizer.fit(maps, props),
                    je2.BinaryVectorizer.fit(maps, props))
    assert ours.index == theirs.index
    for m in maps + [{"color": "green"}, {}]:
        np.testing.assert_array_equal(ours.to_vector(m),
                                      theirs.to_vector(m))
    v = e2.BinaryVectorizer.fit(maps[:2], ["color", "size"])
    assert v.num_features == 3
    assert v.to_vector({"color": "red", "size": "L"}).sum() == 2.0


@pytest.mark.parametrize("k,n", [(2, 10), (3, 10), (4, 7)])
def test_split_data_equals_the_jax_package(k, n):
    data = list(range(n))
    ours = e2.split_data(k, data, to_training=list,
                         to_qa=lambda x: (x, x * 2))
    theirs = je2.split_data(k, data, to_training=list,
                            to_qa=lambda x: (x, x * 2))
    assert ours == theirs and len(ours) == k
    assert sorted(q for _, _, qa in ours for q, _ in qa) == data
    for train, _, qa in ours:
        assert set(train) == set(data) - {q for q, _ in qa}
    with pytest.raises(ValueError):
        e2.split_data(1, data, to_training=list, to_qa=lambda x: (x, x))
