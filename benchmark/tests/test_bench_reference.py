"""The plain reference follows the measured package's semantics: on the
CPU at tiny widths, the port's generator (tuple path at the 32px ladder,
packed branches at the 128px ladder) and SN discriminator against
``benchmark/reference`` on the same seeded tensors, noise draws and
inputs, in f32 with the tanh GELU; then the training step and the served
images compared as a run compares them."""

import json

import pytest
import torch

from benchmark.reference import ffc_gan as ref
from benchmark.reference.train_step import AdamW
from conftest import ROOT


def tiny(name):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg["ngf"] = 8
    return cfg


def port_pair(cfg, gen):
    from fastfourierconvolution_tpu_torch.models.ffc_gan import FFCGenerator, SNConvDiscriminator

    t_g = ref.make_leaves(ref.generator_leaves(cfg), gen, "cpu", cfg["noise_weight_std"])
    t_d = ref.make_leaves(ref.discriminator_leaves(cfg), gen, "cpu", cfg["noise_weight_std"])
    g = FFCGenerator(z_size=cfg["z_size"], ngf=cfg["ngf"], ratio_g=cfg["ratio_g"], mg=cfg["mg"],
                     channel_mults=cfg["channel_mults"], out_channels=cfg["out_channels"])
    d = SNConvDiscriminator.for_resolution(cfg["resolution"])
    g.load_state_dict(t_g)
    d.load_state_dict(t_d)
    return g, d, t_g, t_d


@pytest.mark.parametrize("name, packed", [("fgan32", False), ("fgan128", True)])
def test_generator_and_discriminator_follow_the_port(name, packed, tanh_gelu):
    cfg = tiny(name)
    gen = torch.Generator().manual_seed(5)
    g, d, t_g, t_d = port_pair(cfg, gen)
    assert g.packed == packed
    z = torch.randn(4, cfg["z_size"], generator=gen)
    w = torch.randn(4, 3, cfg["resolution"], cfg["resolution"], generator=gen)
    t_g0 = {k: v.clone() for k, v in t_g.items()}
    names = [k for k in t_g if not ref.is_buffer(k)]
    for k in names:
        t_g[k].requires_grad_(True)
    noise_p, noise_r = (torch.Generator().manual_seed(9) for _ in range(2))
    y_p = g.train()(z, torch.float32, noise_p)
    y_r = ref.generator_forward(t_g, cfg, z, True, lambda s: torch.randn(s, generator=noise_r))
    assert (y_p - y_r).abs().max() < 1e-5
    grads_p = torch.autograd.grad((y_p * w).sum(), list(g.parameters()))
    grads_r = torch.autograd.grad((y_r * w).sum(), [t_g[k] for k in names])
    for (k, _), a, b in zip(g.named_parameters(), grads_p, grads_r):
        assert (a - b).norm() <= 1e-4 * b.norm() + 1e-9, k
    state = g.state_dict()
    for k in t_g:
        if ref.is_buffer(k):
            assert torch.allclose(state[k], t_g[k], atol=1e-7), k
    # eval: the running statistics, no noise
    y_p = g.eval()(z, torch.float32)
    y_r = ref.generator_forward(t_g, cfg, z, False)
    assert (y_p - y_r).abs().max() < 1e-5
    logits_p = d.train()(y_r.detach(), torch.float32)
    logits_r = ref.discriminator_forward(t_d, cfg, y_r.detach())
    assert torch.equal(logits_p, logits_r)
    assert torch.equal(d.state_dict()["conv0.u"], t_d["conv0.u"])
    assert not torch.equal(t_d["conv0.u"], ref.make_leaves(
        ref.discriminator_leaves(cfg), torch.Generator().manual_seed(0), "cpu", 0.1)["conv0.u"])
    del t_g0


def test_adamw_is_torchs():
    gen = torch.Generator().manual_seed(1)
    t = {"w": torch.randn(5, 3, generator=gen)}
    p = torch.nn.Parameter(t["w"].clone())
    opt = torch.optim.AdamW([p], lr=2e-4, betas=(0.5, 0.999), eps=1e-8, weight_decay=0.01)
    mine = AdamW(t, 2e-4, (0.5, 0.999), total_steps=4)
    for step in range(3):
        g = torch.randn(5, 3, generator=gen)
        for group in opt.param_groups:
            group["lr"] = 2e-4 * (1 - step / 4)
        p.grad = g.clone()
        opt.step()
        mine.step(t, {"w": g})
        assert torch.allclose(p.detach(), t["w"], rtol=0, atol=1e-7)


def test_a_tiny_run_is_correct_and_reported(tiny_bench, capsys):
    import json
    import time

    from benchmark.harness import run_cell
    from benchmark.run import report

    for cell in ("tiny.train", "tiny.serve"):
        line = run_cell(tiny_bench, tiny_bench.cell(cell), 2_200_000_001, 0.3, False, "cpu",
                        time.perf_counter())
        assert line["correct"], line["checks"]
        assert line["attempted"] > 0 and line["failed"] == 0
        assert report(line) == 0
        out, err = capsys.readouterr()
        printed = json.loads(out.strip().splitlines()[-1])
        assert list(printed)[-1] == "checks"
        assert set(printed) >= {"correct", "attempted", "failed", "metrics", "device"}
        assert err.strip().splitlines()[-1].startswith("check ")
        assert set(printed["setup_phases"]) >= {"imports", "context", "models", "state", "warm"}
        assert sum(printed["setup_phases"].values()) <= printed["metrics"]["setup_s"]["value"]


@pytest.mark.parametrize("kind, dtype", [("bf16", torch.bfloat16), ("fp8", None)])
def test_precision_rounds_values_and_cotangents(kind, dtype):
    x = torch.randn(64, generator=torch.Generator().manual_seed(3), requires_grad=True)
    q = ref.Precision(kind)
    y = q(x)
    (y * torch.linspace(0.1, 3.7, 64)).sum().backward()
    assert not torch.equal(y, x) and not torch.equal(x.grad, torch.linspace(0.1, 3.7, 64))
    if dtype is not None:
        assert torch.equal(y, x.detach().to(dtype).float())
        assert torch.equal(x.grad, torch.linspace(0.1, 3.7, 64).to(dtype).float())


def test_the_look_counts_rows_zero_on_one_side():
    from benchmark.calibrate import zero_rows

    g_p = torch.tensor([[0.0, 0.0], [1.0, 2.0], [0.0, 0.0]])
    g_r = torch.tensor([[0.0, 0.0], [1.0, 2.0], [3.0, 0.0]])
    d_p = torch.tensor([[0.0, 0.0], [3.0, 4.0], [0.0, 0.0]])
    d_r = torch.tensor([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    row = zero_rows({"kept": {"w": (g_p, d_p)}}, {"kept": {"w": (g_r, d_r)}}, 1.0)["w"]
    assert row == {"rows": 3, "zero_program_only": 1, "zero_reference_only": 0, "zero_both": 1,
                   "gap": pytest.approx(abs(5 - 125 ** 0.5) / 125 ** 0.5), "gap_without": 0.0}
