"""PyTorch port, its examples (``sparkflow_tpu_torch/examples``), second
part: ``serving_example``, ``quantized_serving``, ``streaming_example``,
``rnn_sequence``, ``resnet_cifar`` and ``long_context_lm``, each run
in-process on the CPU at its smoke sizes (``run(device="cpu", smoke=True,
workdir=tmp)``); ``long_context_lm`` launches its two sp ranks over gloo,
as ``tests/test_torch_mesh.py`` runs sp. Also every example's refusal to
run without a card and the command line of one. The first part is
``tests/test_torch_examples.py``.
"""

import importlib

import numpy as np
import pytest

NAMES = ["autoencoder_example", "bert_classifier", "cnn_example",
         "long_context_lm", "quantized_serving", "resnet_cifar",
         "rnn_sequence", "serving_example", "simple_dnn",
         "streaming_example", "text_classifier", "tf1_migration"]


def _port(name):
    return importlib.import_module(f"sparkflow_tpu_torch.examples.{name}")


def _run(name, tmp_path, **kw):
    return _port(name).run(device="cpu", smoke=True, workdir=str(tmp_path),
                           **kw)


def test_serving_example_answers_every_client_without_recompiles(tmp_path):
    res = _run("serving_example", tmp_path)
    assert res["answers"] == 4 and res["accuracy"] >= 0.5
    assert res["recompiles"] == 0
    lat = res["latency_ms"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    assert 0 < res["batch_fill"] <= 1 and np.isfinite(res["losses"]).all()


def test_quantized_serving_serves_every_mode(tmp_path):
    res = _run("quantized_serving", tmp_path)
    assert set(res["error_rate"]) == {"float32", "weight_only", "dynamic"}
    assert all(r <= 0.2 for r in res["error_rate"].values())
    assert np.isfinite(res["losses"]).all()


def test_streaming_example_streams_and_learns(tmp_path):
    res = _run("streaming_example", tmp_path)
    assert res["steps"] == 8           # 2000 rows at 256 a batch
    assert res["losses"][-1] < res["losses"][0]
    assert res["rows_per_s"] > 0


def test_rnn_sequence_classifier_and_char_lm(tmp_path):
    res = _run("rnn_sequence", tmp_path)
    assert 0.5 < res["auc"] <= 1.0
    assert np.isfinite(res["losses"]).all()
    assert res["lm_losses"][-1] < res["lm_losses"][0]
    assert np.isfinite(res["perplexity"]) and res["tokens_per_s"] > 0


def test_resnet_cifar_fits_and_predicts(tmp_path):
    res = _run("resnet_cifar", tmp_path)
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()
    assert 0.0 <= res["accuracy"] <= 1.0


def test_long_context_lm_trains_on_two_sp_ranks(tmp_path):
    res = _run("long_context_lm", tmp_path)
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    # the loss is the global token-weighted mean: both ranks agree
    assert res["rank_losses"][0] == res["rank_losses"][1]
    assert res["tokens_per_s"] > 0
    # on the CPU the kernels' plain versions run: nothing launches
    assert not any(res["launches"].values())


@pytest.mark.parametrize("name", NAMES)
def test_every_example_refuses_to_run_without_a_card(name):
    """No card here: the default device raises before any work, naming
    the way out."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(name).run(smoke=True)


def test_an_example_runs_from_its_command_line(tmp_path, capsys):
    _port("streaming_example").main(["--device", "cpu", "--smoke",
                                     "--workdir", str(tmp_path)])
    assert "steps: 8" in capsys.readouterr().out
