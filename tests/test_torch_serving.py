"""The serving artifact (``serving.py``) and the registered FourierUnit op
against the JAX package, on the CPU in f32.

- The op ``ffc_torch::fourier_unit_forward`` traces to its fake (x's shape
  and dtype, no launch counted) and runs the plain version on the CPU.
- A narrow ``FFCGenerator`` (16px, ngf 16), a narrow packed one, and a
  narrow ``FFCCondGenerator`` and ``CondDCGANGenerator`` with labels (the
  server reads the class count from the model), each on the JAX package's
  seeded variables bridged in, go through ``export_generator``,
  ``save_exported`` and ``load_exported`` and serve batches 1, 3 and 8 (the
  export's example batch is 2): the same bits as the port's in-process
  ``generate``, and within 1 uint8 level of JAX's ``generate`` (its eval
  apply and ``to_uint8``); the artifact's graph calls the op once per
  FourierUnit.
- An export does not leave fake tensors in the port's caches: the eager
  forward after it gives the bits of the one before it.
- The metadata keys are the JAX package's; each package refuses the
  other's artifact by name; platforms and devices are checked.

No test calls the JAX package's ``export_generator`` for real: its
``jax.export`` call is stubbed where its file layout is read.
"""

from __future__ import annotations

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastfourierconvolution_tpu.serving as jserving
from fastfourierconvolution_tpu.models import FFCGenerator as JFFCGenerator
from fastfourierconvolution_tpu.models.conditional import CondDCGANGenerator as JCondDCGANGenerator
from fastfourierconvolution_tpu.models.conditional import FFCCondGenerator as JFFCCondGenerator
from fastfourierconvolution_tpu.models.ffc_gan import to_uint8 as jto_uint8
from fastfourierconvolution_tpu_torch import (
    CondDCGANGenerator,
    FFCCondGenerator,
    FFCGenerator,
    Generator,
    SNGANGenerator,
    serving,
)
from fastfourierconvolution_tpu_torch.bridge import jax_to_state_dict
from fastfourierconvolution_tpu_torch.nn.ffc import FourierUnit
from fastfourierconvolution_tpu_torch.ops import conv, fourier
from fastfourierconvolution_tpu_torch.ops import fourier_unit as fu

from test_torch_ffc import seeded_variables

CLASSES, Z = 3, 16
NARROW = dict(z_size=Z, ngf=16, ratio_g=0.5, mg=4, channel_mults=(2, 1))  # 16px
CASES = {
    "ffc": (JFFCGenerator, FFCGenerator, dict(NARROW, packed=False), 0),
    "packed": (JFFCGenerator, FFCGenerator, dict(NARROW, packed=True), 0),
    "cond": (JFFCCondGenerator, FFCCondGenerator, dict(NARROW, num_classes=CLASSES), CLASSES),
    # no FourierUnit
    "cond-dcgan": (JCondDCGANGenerator, CondDCGANGenerator,
                   dict(nz=Z, nc=3, ngf=16, num_classes=CLASSES), CLASSES),  # 16px
}
OP = torch.ops.ffc_torch.fourier_unit_forward.default


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _op_args(shape=(2, 4, 8, 8), dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    c2 = 2 * shape[1]
    return (torch.randn(shape, generator=g).to(dtype),
            (torch.randn(c2, c2, generator=g) * 0.3).to(dtype),
            torch.rand(c2, generator=g) + 0.5, torch.randn(c2, generator=g) * 0.1,
            torch.randn(c2, generator=g) * 0.1, torch.rand(c2, generator=g) + 0.5)


def test_the_op_traces_to_its_fake_and_runs_the_plain_version():
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _op_args()
    before = fu.fourier_unit_forward.launches
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in _op_args((5, 4, 8, 8), torch.bfloat16)]
        y = torch.ops.ffc_torch.fourier_unit_forward(*fake)
    assert y.shape == (5, 4, 8, 8) and y.dtype == torch.bfloat16
    torch.library.opcheck(OP, args, test_utils=("test_schema", "test_faketensor"))
    assert torch.equal(OP(*args), fu.fourier_unit_forward_plain(*args))
    assert fu.fourier_unit_forward.launches == before  # nothing launched on the CPU


def _case(name):
    jcls, tcls, kw, classes = CASES[name]
    jmodel = jcls(**kw)
    z = jnp.zeros((2, Z))
    extra = (jnp.zeros((2,), jnp.int32),) if classes else ()
    rngs = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda z: jmodel.init(rngs, z, True, *extra), z)
    variables = seeded_variables(shapes, seed=3)
    model = tcls(**kw)
    model.load_state_dict(jax_to_state_dict(model, variables["params"], variables["batch_stats"]))
    server = Generator(model, device="cpu", dtype="f32")
    assert server.num_classes == classes  # read from the model
    return jmodel, variables, server


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_round_trips_at_unseen_batches(name, tmp_path):
    jmodel, variables, server = _case(name)
    classes = server.num_classes
    blob = serving.export_generator(server.sampler(), z_size=Z, num_classes=classes,
                                    image_size=16, step=5)
    path = str(tmp_path / "g.ffcx")
    serving.save_exported(path, blob)
    assert not server.model.training  # the server's eval flag is kept
    call, meta = serving.load_exported(path, "cpu")
    assert meta["num_classes"] == classes and meta["step"] == 5

    _, payload = serving.read_artifact(path)
    graph = torch.export.load(io.BytesIO(payload)).graph
    n_units = sum(isinstance(m, FourierUnit) for m in server.model.modules())
    assert (n_units > 0) == (name != "cond-dcgan")
    assert sum(n.target is OP for n in graph.nodes) == n_units

    jgenerate = jax.jit(lambda v, z, *y: jto_uint8(
        jmodel.apply(v, z, False, *y, rngs={"noise": jax.random.PRNGKey(0)})))
    rng = np.random.default_rng(4)
    for batch in (1, 3, 8):
        z = rng.normal(size=(batch, Z)).astype(np.float32)
        labels = np.arange(batch) % CLASSES if classes else None
        served = call(z, labels)
        assert served.dtype == torch.uint8 and served.shape == (batch, 16, 16, 3)
        assert torch.equal(served, server.generate(z, labels))
        extra = (jnp.asarray(labels),) if classes else ()
        ref = np.asarray(jgenerate(variables, jnp.asarray(z), *extra))
        assert ref.std() > 2  # real images
        assert np.abs(served.numpy().astype(int) - ref.astype(int)).max() <= 1


class _Eval(torch.nn.Module):
    """A generator's eval forward on z (and labels), f32 NHWC."""

    def __init__(self, model, conditional):
        super().__init__()
        self.model, self.conditional = model.eval(), conditional

    def forward(self, z, labels=None):
        args = (z, torch.float32, None) + ((labels,) if self.conditional else ())
        return self.model(*args).permute(0, 2, 3, 1)


def _cache_users():
    g = torch.Generator().manual_seed(8)
    return {
        "ffc": (FFCGenerator(**NARROW, generator=g), False),
        # class-conditional FourierUnits: the factor form in the traced graph
        "cond-spectral-bn": (FFCCondGenerator(**NARROW, num_classes=CLASSES,
                                              cond_spectral_bn=True, generator=g), True),
        # bilinear upsampling: ``conv.bilinear_up_matrix``
        "sngan-resnet": (SNGANGenerator(nz=16, ngf=16, num_blocks=2, generator=g), False),
    }


@pytest.mark.parametrize("name", ["ffc", "cond-spectral-bn", "sngan-resnet"])
def test_an_export_leaves_the_eager_forward_real(name):
    """The DFT-factor and bilinear-weight caches are empty when the export
    traces; the eager forward after it returns real tensors, the bits of
    the forward before it."""
    model, conditional = _cache_users()[name]
    module = _Eval(model, conditional)
    z = torch.randn(3, 16, generator=torch.Generator().manual_seed(9))
    args = (z, torch.arange(3)) if conditional else (z,)
    with torch.no_grad():
        before = module(*args)
        fourier._factor_tensors.cache_clear()
        conv.bilinear_up_matrix.cache_clear()
        batch = torch.export.Dim("b", min=1)
        torch.export.export(module, args, dynamic_shapes=tuple({0: batch} for _ in args))
        after = module(*args)
    assert type(after) is torch.Tensor
    assert torch.equal(after, before)


def _jax_blob(monkeypatch, **meta):
    """The JAX package's artifact bytes with its metadata, ``jax.export``
    stubbed (its payload is not needed)."""

    class Exported:
        def serialize(self):
            return b"stablehlo"

    monkeypatch.setattr(jax.export, "export", lambda fn, platforms: lambda *a: Exported())
    return jserving.export_generator(lambda z: z, **meta)


def test_metadata_keys_are_the_jax_packages(monkeypatch):
    meta = dict(z_size=16, num_classes=3, image_size=16, channels=3, step=7)
    jblob = _jax_blob(monkeypatch, **meta)
    jmeta = json.loads(jblob.split(b"\n")[1])
    _, _, server = _case("cond")
    blob = serving.export_generator(server.sampler(), **meta)
    ours = json.loads(blob.split(b"\n")[1])
    assert list(ours) == list(jmeta)
    assert {k: v for k, v in ours.items() if k != "platforms"} == {
        k: v for k, v in jmeta.items() if k != "platforms"}
    assert ours["platforms"] == ["cpu", "cuda"] and jmeta["platforms"] == ["cpu", "tpu"]


def test_each_package_refuses_the_others_artifact(monkeypatch, tmp_path):
    jax_path, port_path, other = (str(tmp_path / n) for n in ("j.ffcx", "t.ffcx", "x.ffcx"))
    jserving.save_exported(jax_path, _jax_blob(monkeypatch, z_size=16, image_size=16))
    with pytest.raises(ValueError, match="JAX package's FFCX1 artifact"):
        serving.load_exported(jax_path, "cpu")
    _, _, server = _case("ffc")
    serving.save_exported(port_path, serving.export_generator(
        server.sampler(), z_size=16, image_size=16, platforms=("cpu",)))
    with pytest.raises(ValueError, match="not an FFCX artifact"):
        jserving.load_exported(port_path)
    torch.save({"w": torch.zeros(2)}, other)
    with pytest.raises(ValueError, match="not an FFCXT1 artifact"):
        serving.load_exported(other, "cpu")
    # platforms: the artifact's own, and no TPU
    with pytest.raises(ValueError, match=r"exported for \['cpu'\], not cuda"):
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: True)
            m.setattr(torch.cuda, "current_device", lambda: 0)
            serving.load_exported(port_path, "cuda")
    with pytest.raises(ValueError, match="JAX package's export"):
        serving.export_generator(server.sampler(), z_size=16, image_size=16,
                                 platforms=("cpu", "tpu"))
    if not torch.cuda.is_available():  # no quiet fall back to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serving.load_exported(port_path)


def test_a_conditional_server_needs_its_labels():
    _, _, server = _case("cond")
    with pytest.raises(ValueError, match="labels required"):
        server.generate(torch.zeros(2, 16))
    with pytest.raises(ValueError, match=r"labels must be \(2,\)"):
        server.generate(torch.zeros(2, 16), torch.zeros(3))
    _, _, plain = _case("ffc")
    with pytest.raises(ValueError, match="takes no labels"):
        plain.generate(torch.zeros(2, 16), torch.zeros(2))
