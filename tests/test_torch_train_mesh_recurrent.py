"""Port parity, LM training over a device mesh for the recurrent archs:
zamba2-1.2b at 6 layers (its shared block at layer 5) and xlstm-1.3b at 2,
whose recurrent blocks (and zamba2's shared block) compute the rank's
heads, each leaf's gradient summed once over the model ranks that each
computed a part (the sLSTM's custom backward inside), microbatches 1 and
2 each; and xlstm-1.3b with one head over the two model ranks, where the
mLSTM's ranks split the head's value columns and the sLSTM's repeat it
(its gradient taken from one rank of the group, not summed twice).

The machinery is ``tests/test_torch_train_mesh.py``'s: ``repro``'s sharded
``jax.value_and_grad(loss_fn)`` and one AdamW ``make_train_step`` on a
4-device JAX CPU mesh of ``AxisType.Auto`` axes in a subprocess, against
four gloo ranks at (2, 2) on the CPU, at 2e-4; a (1, 1) mesh's step
bit-equal to ctx=None.
"""
import pytest

from test_torch_train_mesh import (Suite, check_loss_and_grads,
                                   check_one_by_one, check_positions,
                                   check_ranks_agree, check_train_step,
                                   mb1_variants, ranks_fixture,
                                   reference_fixture)

SUITE = Suite(
    cases={"zamba2-1.2b": ("zamba2-1.2b", 6, {}),
           "xlstm-1.3b": ("xlstm-1.3b", 2, {}),
           "xlstm-1.3b-h1": ("xlstm-1.3b", 2, {"num_heads": 1})},
    variants={"zamba2-1.2b-mb1": ("zamba2-1.2b", 4, 1, False),
              "zamba2-1.2b-mb2": ("zamba2-1.2b", 4, 2, False),
              "xlstm-1.3b-mb1": ("xlstm-1.3b", 4, 1, False),
              "xlstm-1.3b-mb2": ("xlstm-1.3b", 4, 2, False),
              "xlstm-1.3b-h1-mb1": ("xlstm-1.3b-h1", 4, 1, False)})

reference = reference_fixture(SUITE)
ranks = ranks_fixture(SUITE)


def test_ranks_hold_their_mesh_positions(ranks):
    check_positions(ranks)


@pytest.mark.parametrize("vname", mb1_variants(SUITE))
def test_loss_and_grads_match_repro_sharded(ranks, reference, vname):
    check_loss_and_grads(SUITE, ranks, reference, vname)


@pytest.mark.parametrize("vname", list(SUITE.variants))
def test_train_step_matches_repro_sharded(ranks, reference, vname):
    check_train_step(SUITE, ranks, reference, vname)


@pytest.mark.parametrize("vname", list(SUITE.variants))
def test_ranks_agree_on_metrics_and_replicas(ranks, vname):
    check_ranks_agree(SUITE, ranks, vname)


@pytest.mark.parametrize("name", list(SUITE.cases))
def test_one_by_one_mesh_train_step_is_bit_equal_to_no_ctx(reference, name):
    check_one_by_one(SUITE, reference, name)
