"""A clean step-program source in the port's key layout, for the .json
fixtures: the three continuous-scheduler programs reach ONE ``_runner_for``
site through ``_step_runner``, whose key leads with the caller's kind
literal (as ``paddle_tpu_torch/models/generation.py`` builds it), without
the whole-batch paged path, so a fixture that names this source seeds
exactly one violation. Analyzed on its own it reports clean.

Never imported; read as SOURCE by the AST pass.
"""


class _StepModel:
    def _step_runner(self, kind, shape, kv_cache, eos, decode_kernel,
                     inputs, adapters=None):
        state, state_key = self._state_for_key(kv_cache.dtype)
        NB = inputs["tables"][0][1]
        cache_key = (kind, *shape, NB, kv_cache.signature(), eos, "int64",
                     decode_kernel, ("pool", kv_cache.uid), state_key)
        if adapters is not None:
            cache_key += adapter_key_part(adapters)
        found = self._runner_for(cache_key, lambda: None)
        return found

    def prefill_chunk(self, chunk_ids, offsets, chunk_lens, kv_cache,
                      block_tables, eos_token_id=None, decode_kernel=None):
        S, C = chunk_ids.shape
        eos = -1 if eos_token_id is None else int(eos_token_id)
        return self._step_runner(
            "prefill_chunk", (S, C), kv_cache, eos, decode_kernel,
            {"tables": (block_tables.shape, "int32")})

    def decode_step(self, tokens, lengths, active, kv_cache, block_tables,
                    steps=1, eos_token_id=None, decode_kernel=None):
        S, T = tokens.shape[0], int(steps)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        return self._step_runner(
            "decode_step", (S, T), kv_cache, eos, decode_kernel,
            {"tables": (block_tables.shape, "int32")})

    def verify_step(self, chunk_ids, offsets, draft_lens, active, kv_cache,
                    block_tables, decode_kernel=None):
        S, W = chunk_ids.shape
        return self._step_runner(
            "verify_step", (S, W), kv_cache, -1, decode_kernel,
            {"tables": (block_tables.shape, "int32")})
