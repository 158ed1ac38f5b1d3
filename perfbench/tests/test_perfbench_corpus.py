"""The device generator against Table 1 at a small scale (on the CPU)."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench.harness import corpus


def _config(name):
    from conftest import REPO
    with open(REPO / "perfbench" / "configs" / f"{name}.json") as f:
        return json.load(f)["corpus"]


@pytest.mark.parametrize("name,table1", [
    ("arxiv-k100", (782385, 100000, 141927, 116)),
    ("nyt-k100", (290000, 10000, 102660, 232))])
def test_small_scale_matches_table1(name, table1):
    c = _config(name)
    assert (c["num_train"], c["num_test"], c["vocab_size"],
            c["mean_len"]) == table1
    gen = torch.Generator().manual_seed(2**31 + 3)
    phi = corpus.topics(c["vocab_size"], c["true_topics"], c["beta"], gen)
    assert torch.allclose(phi.sum(1), torch.ones(c["true_topics"]),
                          atol=1e-4)
    s = corpus.make_split(phi, 1500, c["mean_len"], c["min_len"],
                          c["alpha"], gen)
    tokens = float(s.counts.sum())
    assert tokens == float(s.lengths.sum())
    assert abs(tokens / 1500 - c["mean_len"]) < 0.03 * c["mean_len"]
    live = s.counts > 0
    assert int(s.ids[live].max()) < c["vocab_size"]
    assert int(s.ids[live].min()) >= 0
    # unique ids ascending within a row, left-packed, padding id 0
    assert bool((live[:, :-1] | ~live[:, 1:]).all())
    d = s.ids[:, 1:].long() - s.ids[:, :-1].long()
    assert bool((d[live[:, 1:]] > 0).all())
    assert bool((s.ids[~live] == 0).all())
    # words spread over the vocabulary, not bunched at its start
    assert int(s.ids[live].max()) > c["vocab_size"] // 2


def test_relabeled_is_the_same_corpus_under_new_word_names():
    fixed = torch.Generator().manual_seed(11)
    phi = corpus.topics(500, 8, 0.01, fixed)
    s = corpus.make_split(phi, 300, 40, 4, 0.1, fixed)

    def run(seed):
        new_id = torch.randperm(500, generator=torch.Generator()
                                .manual_seed(seed))
        return new_id, corpus.relabeled(s.ids, s.counts, new_id)

    new_id, (ids, cnts) = run(2**31 + 1)
    _, (ids2, cnts2) = run(2**31 + 1)
    _, (ids3, _) = run(17)
    assert torch.equal(ids, ids2) and torch.equal(cnts, cnts2)
    assert not torch.equal(ids, ids3)
    live = cnts > 0
    assert torch.equal(live, s.counts > 0)
    assert bool((ids[~live] == 0).all())
    d = ids[:, 1:].long() - ids[:, :-1].long()
    assert bool((d[live[:, 1:]] > 0).all())         # ascending again
    # each row holds the same (word, count) pairs under the new names
    for r in range(0, 300, 37):
        old = {(int(new_id[w]), float(c)) for w, c in
               zip(s.ids[r][s.counts[r] > 0], s.counts[r][s.counts[r] > 0])}
        new = {(int(w), float(c)) for w, c in
               zip(ids[r][live[r]], cnts[r][live[r]])}
        assert old == new
