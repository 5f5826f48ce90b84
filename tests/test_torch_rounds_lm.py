"""Two rounds of the TransformerLM through ``WaveRunner`` (``wave_mode``
1, the experiment main's default path) against the JAX ``FedAvgAPI``: a
tiny fp32 LM (vocab 90, d_model 32, 2 layers, 2 heads) on
``synthetic_sequences`` at T = 20 (the sequence length the experiment
main trains at), 6 clients in waves of 4 (a ragged last wave), batch 4,
AMSGrad at lr 3e-4, test evaluation every round, the port starting from
the reference's initial weights carried over, both sides packing with
numpy. The JAX side runs its Pallas flash attention in interpret mode,
the port its plain attention (CPU tensors).

Tolerances are the bucketed LM test's: train loss to 1e-6; the global
parameters to lr/2 elementwise with 99.9% of them within 1e-6 (an Adam
step moves an element whose gradient sits near 0 by up to lr either way
when the frameworks' fp32 sums differ in the last bit); the test metrics
to 1e-5."""

import torch_threads  # noqa: F401  (caps torch threads under xdist)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.specs import (
    make_seq_classification_spec as jax_seq_spec)
from fedml_tpu.data.synthetic import load_synthetic_sequences
from fedml_tpu.models.transformer import TransformerLM as JaxLM
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.specs import make_seq_classification_spec
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.utils.torch_import import (lm_state_to_variables,
                                                lm_variables_to_state)

T, V, ROUNDS, LR = 20, 90, 2, 3e-4


def _args():
    return types.SimpleNamespace(
        client_num_in_total=6, client_num_per_round=6, comm_round=ROUNDS,
        epochs=1, batch_size=4, lr=LR, wd=0.0, client_optimizer="adam",
        frequency_of_the_test=1, seed=0, client_chunk=4, wave_mode=1,
        device_resident="auto", device_data_cap_gb=1.0, device_dtype=None)


@pytest.fixture(scope="module")
def trajectories():
    mp = pytest.MonkeyPatch()
    mp.setenv("FEDML_TPU_PACKING", "python")
    try:
        dataset = load_synthetic_sequences(client_num=6, n_train=60,
                                           n_test=12, seq_len=T,
                                           vocab_size=V, seed=0)
        jmodel = JaxLM(vocab_size=V, n_layers=2, n_heads=2, d_model=32,
                       max_len=T, dtype=jnp.float32)
        japi = JaxFedAvgAPI(dataset, jax_seq_spec(
            jmodel, jnp.zeros((1, T), jnp.int32)), _args())
        init = jax.tree.map(np.array, japi.global_state)
        model = TransformerLM(V, n_layers=2, n_heads=2, d_model=32,
                              max_len=T)
        api = FedAvgAPI(dataset, make_seq_classification_spec(model),
                        _args(), device="cpu")
        assert api.device_data is not None
        api.global_state = lm_variables_to_state(init)
        ref, got = [], []
        japi.train(on_round=lambda a, m: ref.append(
            (dict(m), jax.tree.map(np.array, a.global_state))))
        api.train(on_round=lambda a, m: got.append(
            (dict(m), lm_state_to_variables(a.global_state))))
        return ref, got, init
    finally:
        mp.undo()


@pytest.mark.parametrize("rnd", range(ROUNDS))
def test_lm_wave_round_matches_jax_fedavg(trajectories, rnd):
    ref, got, init = trajectories
    (rm, rs), (gm, gs) = ref[rnd], got[rnd]
    assert gm["round"] == rm["round"] == rnd
    np.testing.assert_allclose(gm["Train/Loss"], rm["Train/Loss"], atol=1e-6)
    np.testing.assert_allclose(gm["Train/Acc"], rm["Train/Acc"], atol=1e-6)
    for key in ("Test/Loss", "Test/Acc"):
        np.testing.assert_allclose(gm[key], rm[key], atol=1e-5)
    want = jax.tree_util.tree_leaves_with_path(rs)
    have = dict(jax.tree_util.tree_leaves_with_path(gs))
    start = dict(jax.tree_util.tree_leaves_with_path(init))
    assert len(want) == len(have)
    errs, moved = [], 0.0
    for path, leaf in want:
        np.testing.assert_allclose(have[path], leaf, rtol=0, atol=LR / 2)
        errs.append(np.abs(have[path] - leaf).ravel())
        moved = max(moved, float(np.abs(leaf - start[path]).max()))
    assert np.mean(np.concatenate(errs) > 1e-6) < 1e-3
    assert moved > LR  # the round really trained
