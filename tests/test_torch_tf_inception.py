"""The frozen Inception graph without TensorFlow: the port's GraphDef reader
(`inception_net.read_frozen_graph` / `convert_frozen_graph`) keeps exactly
what the JAX package's TensorFlow converter keeps, and
`$COMPARE_GAN_INCEPTION_PB` resolves to the port's Inception on those
weights.

No real graph is in the repository, so the graph is built with TensorFlow
in the frozen graph's op layout (tests/test_inception_eval.py): Const
weights named like the 2015-12-05 graph, here the port's random-init
weights, plus the int32 plumbing Consts (reduction and concat axes) and the
scalar float Consts (the batch norm's epsilon) that must not reach the npz;
`Mul` input, `pool_3` and `logits` outputs. The port's network from `Mul:0`
on is held to that graph in a TensorFlow session, fed as the JAX package
feeds it (bilinear to 299, (x - 128) / 128): both f32 on the CPU, summing in
other orders through ~95 convolutions, so within 1e-4 of the largest
feature magnitude (measured: 3.1e-6).
"""

import numpy as np
import pytest
import torch

from tests import torch_helpers  # noqa: F401 (one torch thread)

from compare_gan_tpu import eval_utils as jeval_utils
from compare_gan_tpu.metrics import inception_net as jinception
from compare_gan_torch import eval_utils
from compare_gan_torch.metrics import inception_net

pytest.importorskip("tensorflow")

FEATURE_TOL = 1e-4


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for env in (eval_utils.INCEPTION_NPZ_ENV, eval_utils.INCEPTION_PB_ENV):
        monkeypatch.delenv(env, raising=False)
    eval_utils._resolved_fns.clear()
    yield
    eval_utils._resolved_fns.clear()


def test_frozen_graph_reads_as_the_jax_converter_writes(tmp_path,
                                                        monkeypatch):
    from tests.test_inception_eval import _build_tf_graphdef
    params = inception_net.init_random(torch.Generator().manual_seed(2))
    pb = tmp_path / "inception_synthetic.pb"
    pb.write_bytes(_build_tf_graphdef(params).SerializeToString())

    mine, ref = tmp_path / "mine.npz", tmp_path / "ref.npz"
    inception_net.convert_frozen_graph(str(pb), str(mine))
    jinception.convert_frozen_graph(str(pb), str(ref))
    with np.load(mine) as got, np.load(ref) as want:
        assert got.files == want.files  # same names, same order
        assert set(got.files) == set(params)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # $COMPARE_GAN_INCEPTION_PB resolves to the port's Inception on the
    # graph's weights; the graph in a TF session (the JAX package's
    # backend) is the yardstick.
    monkeypatch.setenv(eval_utils.INCEPTION_PB_ENV, str(pb))
    fn = eval_utils.get_inception_fn("cpu")
    assert eval_utils.get_inception_fn("cpu") is fn  # memoized
    images = (np.random.RandomState(0).rand(2, 64, 64, 3) * 255).astype(
        np.float32)
    pool, logits = fn(images)
    pool_tf, logits_tf = jeval_utils._tf_frozen_graph_fn(str(pb))(images)
    for what, got, want in (("pool_3", pool, pool_tf),
                            ("logits", logits, logits_tf)):
        assert got.shape == want.shape, what
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FEATURE_TOL * scale, err_msg=what)

    # $COMPARE_GAN_INCEPTION_NPZ comes first, as in the JAX package.
    monkeypatch.setenv(eval_utils.INCEPTION_NPZ_ENV, str(mine))
    by_npz = eval_utils.get_inception_fn("cpu")
    assert by_npz is not fn
    np.testing.assert_array_equal(by_npz(images)[0], pool)
