"""Seeded ``unbounded-key`` violation: a whole-batch ``generate`` whose
cache key holds the raw per-request ``max_new_tokens`` (no bucket), so
every distinct budget a client sends captures a new program. The port's
real ``generate()`` keys on ``bucket_new_tokens(n)`` instead.

Never imported; read as SOURCE by the AST pass.
"""


class _DenseModel:
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, eos_token_id=None, decode_kernel="kernel"):
        B, P = input_ids.shape
        n = int(max_new_tokens)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        cache_key = ("dense", B, P, n, eos, str(input_ids.dtype),
                     decode_kernel)
        run, compiled_now = self._runner_for(cache_key, lambda: None)
        return run
