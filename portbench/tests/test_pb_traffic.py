"""The request mix and the traffic drivers: seeded, and what the program
is sent is what the reference expects it to be sent."""

import numpy as np

from portbench import weights
from portbench.mix import Mix
from portbench.reference import serving
from portbench.traffic import closed, poisson

from .conftest import TINY_DENSE

PARAMS = {"chars_median": 40, "chars_sigma": 0.5, "chars_min": 8,
          "chars_max": 120, "codes_per_char": 3.1, "temperature": 0.8,
          "greedy_share": 0.125}
BIG_SEED = 2 ** 31 + 12345


def test_same_seed_same_requests_in_any_order():
    a, b = Mix(PARAMS, BIG_SEED), Mix(PARAMS, BIG_SEED)
    first = [a.request(c, k) for c in range(8) for k in range(5)]
    second = [b.request(c, k) for k in reversed(range(5))
              for c in reversed(range(8))]
    key = lambda r: (r.client, r.index)  # noqa: E731
    assert sorted(first, key=key) == sorted(second, key=key)
    assert Mix(PARAMS, BIG_SEED + 1).request(0, 0) != a.request(0, 0)


def test_mix_lengths_budgets_and_greedy_share():
    m = Mix(PARAMS, 7)
    reqs = [m.request(c, k) for c in range(64) for k in range(20)]
    n = np.array([r.n_chars for r in reqs])
    assert n.min() >= 8 and n.max() <= 120
    assert 36 <= np.median(n) <= 44
    for r in reqs:
        assert len(r.text) == r.n_chars
        assert len(r.text.encode("utf-8")) == 3 * r.n_chars
        assert r.max_tokens == round(3.1 * r.n_chars)
        assert 0 <= r.seed < 2 ** 62
    greedy = np.mean([r.temperature == 0 for r in reqs])
    assert 0.09 < greedy < 0.16
    assert max(len(serving.prompt_ids(r.text)) for r in reqs) <= \
        m.prompt_bytes_max() == 380


def test_texts_pass_normalisation_and_tokenize_as_the_reference_says():
    from miotts_tpu_torch.gguf import GGUFReader
    from miotts_tpu_torch.text import build_prompt, normalize_tts_text
    from miotts_tpu_torch.text.tokenizer import Tokenizer
    model = weights.make_llm(weights.shape_of(TINY_DENSE), 1, "cpu")
    with weights.memory_file(model, "llm") as path, GGUFReader(path) as r:
        tok = Tokenizer.from_gguf(r)
    m = Mix(PARAMS, BIG_SEED)
    for k in range(40):
        text = m.request(k % 3, k).text
        assert normalize_tts_text(text) == text
        assert tok.encode(build_prompt(text)) == serving.prompt_ids(text)


def test_closed_loop_staggers_the_lead_in_and_refills_on_finish():
    d = closed.Driver({"clients": 4, "lead_in_max_tokens": 40},
                      Mix(PARAMS, 3))
    lead = d.begin(10.0)
    assert [r.max_tokens for r, _ in lead] == [4, 16, 28, 40]
    assert all(r.lead_in and due == 10.0 for r, due in lead)
    assert d.in_lead_in(11.0) and d.poll(11.0) == []
    for r, _ in lead[:3]:
        d.finished(r, 12.0)
    sent = d.poll(12.5)
    assert [(r.client, r.index, due) for r, due in sent] == [
        (0, 1, 12.5), (1, 1, 12.5), (2, 1, 12.5)]
    assert not any(r.lead_in for r, _ in sent) and d.in_lead_in(13.0)
    d.finished(lead[3][0], 13.0)
    assert not d.in_lead_in(13.0)


def test_poisson_arrivals_are_seeded_and_report_lateness():
    p = {"rate_per_s": 20.0, "lead_in_s": 1.0, "horizon_s": 30.0}
    a = poisson.Driver(p, Mix(PARAMS, 11))
    b = poisson.Driver(p, Mix(PARAMS, 11))
    assert np.array_equal(a.arrivals, b.arrivals)
    gaps = np.diff(a.arrivals)
    assert abs(gaps.mean() - 1 / 20.0) < 0.01
    a.begin(100.0)
    got = []
    for t in np.arange(100.0, 110.0, 0.25):
        got += [(r, due, t) for r, due in a.poll(t)]
    assert len(got) == int(np.sum(a.arrivals <= 9.75))
    for r, due, t in got:
        assert due <= t < due + 0.25
        assert r.lead_in == (due < 101.0)
    rep = a.report()
    assert rep["sent"] == len(got)
    assert 0 <= rep["late_p50_s"] <= rep["late_p95_s"] <= rep["late_max_s"] < 0.25
    assert a.in_lead_in(100.5) and not a.in_lead_in(101.0)


def _digest(reqs) -> str:
    import hashlib
    h = hashlib.sha256()
    for r in reqs:
        h.update(repr((r.text, r.n_chars, r.max_tokens, r.temperature,
                       r.seed)).encode())
    return h.hexdigest()


def test_without_strata_the_draws_are_the_closed_cells_own():
    """Values from the code before `strata` came in: a cell that does not
    name it sends the same requests at the same times."""
    import hashlib
    m = Mix(PARAMS, BIG_SEED)
    assert _digest(m.request(c, k) for c in range(4) for k in range(50)) \
        == "3b3ec8b93e347cbdd14cdd2727b5404b0be101ca766a9fa7e1d9484629ce9ea3"
    d = poisson.Driver({"rate_per_s": 14.4, "lead_in_s": 10,
                        "horizon_s": 30.0}, m)
    assert len(d.arrivals) == 664
    assert hashlib.sha256(d.arrivals.tobytes()).hexdigest() == \
        "34cfca8c3ec0ea8a7c4c55681b5ad4bfccc541ee1bdbfe0c5c488433ddf56b70"


def test_strata_give_every_seed_the_same_work_in_another_order():
    b, rate = 32, 14.4
    p = {"rate_per_s": rate, "lead_in_s": 10, "horizon_s": 30.0,
         "strata": b}
    mp = dict(PARAMS, strata=b)
    sets = []
    for seed in (BIG_SEED, BIG_SEED + 1):
        m = Mix(mp, seed)
        d = poisson.Driver(p, m)
        gaps = np.diff(np.concatenate([[0.0], d.arrivals]))
        blocks = gaps[:len(gaps) // b * b].reshape(-1, b)
        assert np.allclose(blocks.sum(axis=1), b / rate)
        assert np.allclose(np.sort(blocks, axis=1), np.sort(blocks[0]))
        reqs = [m.request(0, k) for k in range(4 * b)]
        n = np.array([r.n_chars for r in reqs]).reshape(4, b)
        greedy = np.array([r.temperature == 0 for r in reqs]).reshape(4, b)
        assert (np.sort(n, axis=1) == np.sort(n[0])).all()
        assert (greedy.sum(axis=1) == round(b * PARAMS["greedy_share"])).all()
        assert 8 <= n.min() and n.max() <= 120
        assert 36 <= np.median(n) <= 44
        for r in reqs:
            assert len(r.text) == r.n_chars
            assert r.max_tokens == round(3.1 * r.n_chars)
        sets.append((np.sort(n[0]), np.sort(blocks[0]), n, blocks))
    (na, ga, order_a, blk_a), (nb, gb, order_b, blk_b) = sets
    assert (na == nb).all() and np.allclose(ga, gb)
    assert not (order_a == order_b).all()
    assert not np.allclose(blk_a, blk_b)
