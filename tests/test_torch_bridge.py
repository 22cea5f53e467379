"""``bridge.py`` for the three model families: JAX's state goes into the
port model its config names, with or without the top prefix, and comes
back under JAX's names with the same values; a missing, extra or
misshapen name raises."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import from_paddle_tpu_state, to_paddle_tpu_state
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models import llama as tllama

GPT2 = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
            max_position=32, use_rope=False, use_rms_norm=False,
            use_swiglu=False, tie_embeddings=False)
FAMILIES = {
    "gpt": (lambda: jgpt.GPTForCausalLM(jgpt.GPTConfig(**GPT2)),
            lambda: tgpt.GPTConfig(**GPT2), "gpt"),
    "llama": (lambda: jllama.LlamaForCausalLM(jllama.llama_tiny()),
              tllama.llama_tiny, "llama"),
    "bert": (lambda: jbert.BertForMaskedLM(jbert.bert_tiny()),
             tbert.bert_tiny, "bert"),
}


def _jax_state(family):
    make, _, _ = FAMILIES[family]
    with paddle.utils.unique_name.guard():
        paddle.seed(3)
        jm = make()
    return {k: np.asarray(v) for k, v in jm.raw_state().items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("prefixed", [True, False])
def test_round_trip_keeps_names_and_values(family, prefixed):
    _, config, top = FAMILIES[family]
    state = _jax_state(family)
    given = state if prefixed else {
        k[len(top) + 1:] if k.startswith(top + ".") else k: v
        for k, v in state.items()}
    back = to_paddle_tpu_state(from_paddle_tpu_state(given, config(),
                                                     device="cpu"))
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_missing_extra_or_misshapen_name_raises(family):
    _, config, _ = FAMILIES[family]
    state = _jax_state(family)
    name = sorted(state)[0]
    missing = {k: v for k, v in state.items() if k != name}
    with pytest.raises(ValueError, match="missing"):
        from_paddle_tpu_state(missing, config(), device="cpu")
    extra = dict(state, **{"nowhere.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        from_paddle_tpu_state(extra, config(), device="cpu")
    bad = dict(state, **{name: np.zeros(state[name].shape + (1,),
                                        np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_paddle_tpu_state(bad, config(), device="cpu")


def test_unknown_config_raises():
    with pytest.raises(TypeError, match="no port model"):
        from_paddle_tpu_state({}, object(), device="cpu")
