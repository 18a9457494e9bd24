"""JAX ONNX runtime (export/onnx_jax.py): jit-compiled graphs score
identically to the live Flax model and the numpy evaluator, and
NanoInterpreter loads `.onnx` files directly (the reference's model format,
nanointerpreter.py:873-877)."""

import numpy as np
import pytest

from nanowakeword_tpu.export import onnx_eval
from nanowakeword_tpu.export.onnx_export import build_onnx, export_onnx
from nanowakeword_tpu.export.onnx_jax import OnnxJaxModel
from nanowakeword_tpu.models.model import Model


def _model(model_type="dnn", activation="relu"):
    config = {"activation_function": activation, "embedding_dim": 16,
              "crnn_cnn_channels": [8, 16], "crnn_rnn_type": "gru",
              "conformer_d_model": 32, "conformer_n_head": 2}
    return Model(config=config, model_name="oj", input_shape=(16, 96),
                 model_type=model_type, layer_dim=24, n_blocks=2,
                 dropout_prob=0.0)


def _score_jax(model, feats):
    logits = np.asarray(model(feats))
    return 1.0 / (1.0 + np.exp(-logits))


# one family per op-coverage class: Gemm/LN, Conv2D/MaxPool, dilated
# Conv1D, native GRU scan, lowered MHSA, conv-stack+BN+GRU, depthwise
# conv/GLU/BN-in-NCL
@pytest.mark.parametrize("model_type", [
    "dnn", "cnn", "tcn", "gru", "transformer", "crnn", "conformer"])
def test_matches_live_model(model_type):
    model = _model(model_type)
    data = build_onnx(model)
    runtime = OnnxJaxModel(data)
    feats = np.random.default_rng(0).normal(
        size=(1, 16, 96)).astype(np.float32)
    got = runtime(feats)
    np.testing.assert_allclose(got, _score_jax(model, feats), atol=1e-5)
    # and agrees with the numpy evaluator bit-for-bit-ish
    ref = onnx_eval.run(data, {"features": feats})["score"]
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_ort_compatible_run_interface():
    model = _model("dnn")
    runtime = OnnxJaxModel(build_onnx(model))
    feats = np.random.default_rng(1).normal(
        size=(1, 16, 96)).astype(np.float32)
    out = runtime.run(["score"], {"features": feats})
    assert isinstance(out, list) and out[0].shape == (1, 1)
    assert runtime.input_shape == ["batch_size", 16, 96]
    assert runtime.output_names == ["score"]


class TestInterpreterLoadsOnnx:
    def test_predict_clip_matches_nww(self, tmp_path):
        """The same weights loaded via .onnx and via .nww produce the same
        score trace on the same audio."""
        from nanowakeword_tpu.export.artifact import save_nww
        from nanowakeword_tpu.interpreter.nanointerpreter import \
            NanoInterpreter

        model = _model("dnn")
        onnx_path = export_onnx(model, str(tmp_path / "m.onnx"))
        nww_path = save_nww(str(tmp_path / "m.nww"), model=model,
                            config=model.config, model_name="m")

        audio = (np.random.default_rng(2).integers(
            -8000, 8000, 32000)).astype(np.int16)
        itp_o = NanoInterpreter.load_model(onnx_path)
        itp_n = NanoInterpreter.load_model(nww_path)
        s_o = itp_o.predict_clip(audio)
        s_n = itp_n.predict_clip(audio)
        assert len(s_o) == len(s_n) > 0
        for a, b in zip(s_o, s_n):
            np.testing.assert_allclose(a.get("m"), b.get("m"), atol=1e-4)

    def test_feature_length_read_from_graph(self, tmp_path):
        from nanowakeword_tpu.interpreter.nanointerpreter import \
            NanoInterpreter
        model = _model("dnn")
        path = export_onnx(model, str(tmp_path / "m.onnx"))
        itp = NanoInterpreter.load_model(path)
        assert itp.model_feature_length["m"] == 16

    def test_onnx_lite_gate_autodiscovered(self, tmp_path):
        """cascade=True finds `<stem>_lite.onnx` beside a .nww verifier —
        the reference's discovery behavior (nanointerpreter.py:443-487)."""
        from nanowakeword_tpu.export.artifact import save_nww
        from nanowakeword_tpu.interpreter.nanointerpreter import \
            NanoInterpreter
        model = _model("dnn")
        save_nww(str(tmp_path / "big.nww"), model=model,
                 config=model.config, model_name="big")
        export_onnx(_model("dnn", "silu"), str(tmp_path / "big_lite.onnx"))
        itp = NanoInterpreter.load_model(str(tmp_path / "big.nww"),
                                         cascade=True)
        assert itp.is_cascade
        assert itp.gate_name == "big_lite"
