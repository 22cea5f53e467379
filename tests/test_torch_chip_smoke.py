"""The pure helpers of ``chip_smoke.py`` (the port's measurement script),
on the CPU: the per-kernel register and spill summary it reads from the
``nvcc -Xptxas -v`` log, and the record that sets dq + dk/dv against the
library's one backward call."""
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__4af27cb8_18_flash\
_attention_cu_62ae58a722flash_dkv_wgmma_kernelILi64ELb1EEEvPK13__nv_bfloat16S3\
_S3_S3_PKfS5_PS1_S6_PKiiifiii' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__4af27cb8_18_flash\
_attention_cu_62ae58a722flash_dkv_wgmma_kernelILi64ELb1EEEvPK13__nv_bfloat16S3\
_S3_S3_PKfS5_PS1_S6_PKiiifiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123split_kv_combine\
_kernelI13__nv_bfloat16Li128EEEvPKfS3_S3_PT_iiiiiii' for 'sm_90a'
    16 bytes stack frame, 36 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 32 registers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121paged_partials\
_kernelIfLi64EEEvPKT_' for 'sm_90a'
ptxas info    : Used 128 registers
ptxas info    : Compiling entry function '_Z10foo_kerneliPf' for 'sm_90a'
ptxas info    : Used 12 registers
"""


def test_ptxas_summary_names_each_kernel_with_its_arguments():
    assert chip_smoke.ptxas_summary(_LOG) == [
        ("flash_dkv_wgmma_kernel<64,1>", 168, 0),
        ("split_kv_combine_kernel<bf16,128>", 32, 36),
        ("paged_partials_kernel<float,64>", 128, 0),
        ("foo_kernel", 12, 0)]
    assert chip_smoke.ptxas_summary("nvcc: nothing compiled\n") == []


@pytest.mark.parametrize("masked", [False, True])
def test_whole_backward_sets_dq_plus_dkv_against_the_library(masked,
                                                             capsys):
    def rec(ms, bound, unmasked):
        r = dict(ms=ms, library_ms=0.25, library_call="sdpa backward",
                 bound_ms=bound)
        if masked:
            r["unmasked_ms"] = unmasked
        return r

    out = chip_smoke.whole_backward(
        {"dq": rec(0.1, 0.02, 0.3), "dkv": rec(0.15, 0.03, 0.4),
         "fwd": rec(9.0, 9.0, 9.0)}, B=1, S=64)
    assert out["kernel"] == "dq+dkv" and (out["B"], out["S"]) == (1, 64)
    assert out["ms"] == pytest.approx(0.25)
    assert out["over_library"] == pytest.approx(1.0)
    assert out["bound_ms"] == pytest.approx(0.05)
    assert out["library_call"] == "sdpa backward"
    if masked:
        assert out["unmasked_ms"] == pytest.approx(0.7)
    else:
        assert "unmasked_ms" not in out
    assert capsys.readouterr().out.startswith("backward-time {")
