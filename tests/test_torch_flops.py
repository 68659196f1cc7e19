"""The port's FLOP and byte accounting (kind_tpu_sim_torch/models/flops.py)
against the reference's (kind_tpu_sim/models/flops.py).

Both are the same pure arithmetic over the same ModelConfig fields, so
every function must give the reference's number exactly (or within
rel 1e-12) on the tiny config, the flagship, a 4-expert MoE and the
int8 configs. The analytic FLOPs are also held to PyTorch's own count of
the port's matmuls (FlopCounterMode), as the reference's are held to
XLA's cost analysis: they sit just below it (elementwise work is left
out on purpose) and never above it.
"""

import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from kind_tpu_sim.models import flops as RF
from kind_tpu_sim_torch.models import flops as PF
from kind_tpu_sim_torch.models import transformer as ptf

from torch_parity import jax_cfg

H100 = "NVIDIA H100 80GB HBM3"
CONFIGS = {
    "tiny": ptf.ModelConfig(),
    "flagship": ptf.bench_config_large(),
    "moe4": dataclasses.replace(ptf.bench_config_large(), n_experts=4),
    "int8_kv": dataclasses.replace(ptf.bench_config_large(), int8_kv=True),
    "int8_native": dataclasses.replace(ptf.bench_config_large(),
                                       int8_kv=True, int8_native=True),
    "remat": dataclasses.replace(ptf.bench_config_large(), remat=True),
}


def _ref_spec(spec):
    return RF.ChipSpec(**dataclasses.asdict(spec))


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_function_equals_the_reference(name):
    cfg = CONFIGS[name]
    ref = jax_cfg(cfg)
    spec = PF.chip_spec(H100)
    rspec = _ref_spec(spec)
    _same(PF.matmul_params(cfg), RF.matmul_params(ref))
    for b, t in ((2, 128), (8, 1024), (2, 4096)):
        for flash in (False, True):
            for backward in (False, True):
                for optimizer in (False, True):
                    _same(PF.step_peak_bytes(cfg, b, t, flash, backward,
                                             optimizer),
                          RF.step_peak_bytes(ref, b, t, flash, backward,
                                             optimizer))
                _same(PF.train_step_breakdown(cfg, b, t, spec, flash,
                                              backward),
                      RF.train_step_breakdown(ref, b, t, rspec, flash,
                                              backward))
    for seq in (1, 127, 1023, 4096):
        _same(PF.fwd_flops_per_token(cfg, seq),
              RF.fwd_flops_per_token(ref, seq))
        _same(PF.train_flops_per_token(cfg, seq),
              RF.train_flops_per_token(ref, seq))
        for causal in (False, True):
            _same(PF.attention_flops(seq, cfg.n_heads, cfg.head_dim, 3,
                                     causal),
                  RF.attention_flops(seq, cfg.n_heads, cfg.head_dim, 3,
                                     causal))
    _same(PF.mfu(51234.0, PF.train_flops_per_token(cfg, 1023), spec),
          RF.mfu(51234.0, RF.train_flops_per_token(ref, 1023), rspec))
    for wb, kb in ((2, 2), (1, 2), (2, 1), (1, 1)):
        _same(PF.decode_bytes_per_step(cfg, 8, 1536, wb, kb),
              RF.decode_bytes_per_step(ref, 8, 1536, wb, kb))
        _same(PF.decode_roofline(cfg, 8, 1536, 2450.0, spec, wb, kb),
              RF.decode_roofline(ref, 8, 1536, 2450.0, rspec, wb, kb))


# tests/test_flops.py's config and batch
CFG = ptf.ModelConfig(vocab_size=512, d_model=128, n_heads=4, n_layers=2,
                      d_ff=512, max_seq=128, dtype="float32")


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _inputs():
    params = ptf.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    tokens = ptf.sample_batch(torch.Generator().manual_seed(1), CFG, 4,
                              CFG.max_seq, device="cpu")
    return params, tokens


def test_fwd_flops_match_the_counted_flops():
    params, tokens = _inputs()
    with torch.no_grad():
        counted = _counted(lambda: ptf.loss_fn(params, tokens, CFG))
    # loss_fn's forward runs on seq-1 tokens (next-token shift)
    analytic = PF.fwd_flops_per_token(CFG, CFG.max_seq - 1) \
        * 4 * (CFG.max_seq - 1)
    assert 0.75 * counted <= analytic <= counted


def test_train_flops_match_the_counted_flops():
    params, tokens = _inputs()
    leaves = ptf._leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    counted = _counted(lambda: torch.autograd.grad(
        ptf.loss_fn(params, tokens, CFG), leaves))
    analytic = PF.train_flops_per_token(CFG, CFG.max_seq - 1) \
        * 4 * (CFG.max_seq - 1)
    assert 0.75 * counted <= analytic <= counted


def test_chip_spec_h100_unknown_and_override(monkeypatch):
    monkeypatch.delenv("TPU_SIM_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("TPU_SIM_PEAK_GBPS", raising=False)
    spec = PF.chip_spec(H100)
    assert (spec.peak_bf16_tflops, spec.peak_int8_tops, spec.hbm_gbps) == (
        989.0, 1979.0, 3350.0)
    assert 79 < spec.hbm_gib < 80
    for name in ("TPU v5 lite", "something-new", None):
        with pytest.raises(ValueError, match="no chip spec"):
            PF.chip_spec(name)
    monkeypatch.setenv("TPU_SIM_PEAK_TFLOPS", "100")
    spec = PF.chip_spec(H100)
    assert spec.peak_bf16_tflops == 100.0
    assert spec.hbm_gbps == 3350.0
    assert spec.name.endswith("-override")
    monkeypatch.setenv("TPU_SIM_PEAK_GBPS", "2000")
    assert PF.chip_spec(H100).hbm_gbps == 2000.0
    # the reference's override, for the same environment
    assert RF.chip_spec("TPU v5 lite").peak_bf16_tflops == 100.0
