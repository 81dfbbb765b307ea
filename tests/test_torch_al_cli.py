"""The port's ``active_learning`` CLI (``python -m
semanticsegmentationactivelearning_tpu_torch.active_learning``) end to
end on the CPU (``--device cpu``): ENet-19 at 32x64 on synthetic
Cityscapes-layout records written with the port's ``example`` and
``tfrecord`` (16 train records and 4 test records; colour blocks that
give the class), batch 4, the AL conf's loss, optimizer, measure,
threshold and pseudo proportion, with ``epochs`` 1, no warm-up, 4
initially labelled, 3 selected a round and a learning rate of 1e-7 (as
``tests/test_active_learning_cli.py`` bounds the JAX CLI's rounds).
The rounds run without a validation set, so that each is one epoch;
the baseline and ``-r`` runs hold 4 records out for it.

- ``init_or_load_state`` gives the root ``active_learning.py``'s
  ``state.json`` for the same seed and files, with and without ``-u``;
- two rounds, then a resume to a third: the JAX schema of
  ``state.json``, a labelled set that grows by ``selection_size`` a
  round and stays disjoint from the unlabelled set, the round
  directories' checkpoints, and the ``metrics.jsonl`` records with the
  splits and keys of the root CLI's ``writer.write`` calls (read from
  its source, with ``al_timing``'s phase keys);
- the random baseline (a negative ``selection_size``): no pool pass;
- ``-c <round 1's best> -r``: the output layer drawn anew;
- the size buckets of a mixed-size pool leave the scores and the
  selection unchanged;
- one round with the BALD measure (``mc_passes`` 3) and one with
  core-set selection, checked as tests/test_active_learning_cli.py
  checks the root CLI's (the log lines, ``state.json``'s labelled set
  grown by the selection size without repeats, one ``al_confidence``
  or one ``al_coreset`` record), and the BALD measure's ``ValueError``
  on a model without active dropout (all ``dropout_rates`` 0);
- ICNet (the AL conf with ``network.model`` ICNet and its cascade loss,
  ``softmax.multiscale``): one entropy round and one core-set round,
  checked as above, and BALD's ``ValueError`` (ICNet has no dropout)
  before ``state.json`` is written;
- the default ``--device cuda`` raises without a card, a bf16 conf
  raises and names its ROADMAP item, and ``-m nir`` on RGB records
  raises the loader's missing-modality ``ValueError``.

Measured: about 26 s on one process.
"""

import ast
import importlib.util
import io
import json
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image

from semanticsegmentationactivelearning_tpu_torch import active_learning as al
from semanticsegmentationactivelearning_tpu_torch.data import (example, loader,
                                                               tfrecord)
from semanticsegmentationactivelearning_tpu_torch.models import ENet
from semanticsegmentationactivelearning_tpu_torch.train import checkpoint
from semanticsegmentationactivelearning_tpu_torch.train.steps import (
    make_score_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 64)
COLORS = np.array([(200, 40, 40), (40, 200, 40), (40, 40, 200),
                   (200, 200, 40), (40, 200, 200)], np.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _png(a):
    b = io.BytesIO()
    Image.fromarray(a).save(b, format="PNG")
    return b.getvalue()


def _write(path, rng, hw, name):
    idx = rng.integers(0, len(COLORS), (hw[0] // 8, hw[1] // 8))
    label = np.kron(idx, np.ones((8, 8), np.int64)).astype(np.uint8)
    img = np.clip(COLORS[label].astype(int) + rng.integers(-20, 20,
                                                           (*hw, 3)),
                  0, 255).astype(np.uint8)
    ex = example.SegExample(file_id=name, height=hw[0], width=hw[1],
                            label=_png(label),
                            modalities={"image": (_png(img), "png", 3)})
    tfrecord.write_record_file(str(path), example.make_example(ex))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    rng = np.random.default_rng(0)
    for split, n in (("train", 16), ("val", 4), ("unlabelled", 2)):
        os.makedirs(root / split)
        for i in range(n):
            _write(root / split / f"{i:02d}.tfrecord", rng, HW,
                   f"{split}{i}")
    return root


def _conf(tmp, name, iterations=2, selection_size=3, num_validation=4,
          **over):
    with open(os.path.join(REPO, "conf",
                           "enet_cityscapes_active_learning.json")) as fp:
        conf = json.load(fp)
    conf["batch_size"] = 4
    conf["epochs"] = 1
    conf["hyperparams"]["learning_rate"] = 1e-7
    conf["network"]["input"] = {"height": HW[0], "width": HW[1]}
    conf["active_learning"].update(
        iterations=iterations, num_initially_labelled=4,
        num_validation=num_validation, selection_size=selection_size,
        **{"epochs/warm_up": 0})
    conf["image_summaries"] = {"pseudo_cadence": 1, "count": 1}
    for key, value in over.items():
        section, _, leaf = key.partition("__")
        conf[section][leaf] = value
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as fp:
        json.dump(conf, fp)
    return path


def _run(records, log, conf, *extra):
    return al.main(al.parse_args(["cityscapes", "-d", str(records), "-l",
                                  str(log), "-p", conf, "--device", "cpu",
                                  *extra]))


def _records(log):
    with open(os.path.join(log, "metrics.jsonl")) as fp:
        return [json.loads(line) for line in fp]


def _state(log):
    with open(os.path.join(log, "state.json")) as fp:
        return json.load(fp)


def _root_cli():
    spec = importlib.util.spec_from_file_location(
        "root_active_learning", os.path.join(REPO, "active_learning.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _root_cli_records():
    """split -> the keys of the record the root active_learning.py
    writes for it (its ``writer.write({...})`` calls; ``al_timing``'s
    ``**`` keys are its ``_phase_s[...]`` names with ``_s``)."""
    with open(os.path.join(REPO, "active_learning.py")) as fp:
        tree = ast.parse(fp.read())
    phases = {node.slice.value for node in ast.walk(tree)
              if isinstance(node, ast.Subscript)
              and getattr(node.value, "id", None) == "_phase_s"
              and isinstance(node.slice, ast.Constant)}
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "write"
                and node.args and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            keys = {k.value for k in d.keys if k is not None}
            if None in d.keys:
                keys |= {f"{p}_s" for p in phases}
            split = d.values[[k.value if k is not None else None
                              for k in d.keys].index("split")].value
            out[split] = keys | {"wall_time"}
    return out


@pytest.mark.parametrize("unlabelled", [False, True])
def test_init_state_matches_the_root_cli(records, tmp_path, unlabelled):
    args = types.SimpleNamespace(
        data_dir=str(records), dataset="cityscapes",
        unlabelled=str(records / "unlabelled") if unlabelled else None)
    alparams = {"num_validation": 4, "num_initially_labelled": 5}
    root = _root_cli()
    want = root.init_or_load_state(str(tmp_path / "a.json"), args, alparams,
                                   np.random.default_rng(3))
    got = al.init_or_load_state(str(tmp_path / "b.json"), args, alparams,
                                np.random.default_rng(3))
    assert got == want
    with open(tmp_path / "a.json") as a, open(tmp_path / "b.json") as b:
        assert a.read() == b.read()
    assert len(got["dataset"]["train"]["no_label"]) == (2 if unlabelled
                                                        else 0)


@pytest.fixture(scope="module")
def rounds(records, tmp_path_factory):
    """Two rounds, then a resume to a third, without a validation set:
    each round is one epoch, which commits its checkpoint."""
    tmp = str(tmp_path_factory.mktemp("rounds"))
    log = os.path.join(tmp, "log")
    assert _run(records, log, _conf(tmp, "two", num_validation=0)) == 0
    two = _state(log)
    assert _run(records, log, _conf(tmp, "three", iterations=3,
                                    num_validation=0)) == 0
    return log, two, _state(log), _records(log)


def test_state_json_rounds(rounds):
    log, two, three, _ = rounds
    assert set(three) == {"checkpoint", "iteration", "dataset"}
    assert set(three["dataset"]) == {"train", "val", "test"}
    assert set(three["dataset"]["train"]) == {"filenames", "labelled",
                                              "unlabelled", "no_label"}
    assert (two["iteration"], three["iteration"]) == (2, 3)
    for state, rounds_done in ((two, 2), (three, 3)):
        lab = state["dataset"]["train"]["labelled"]
        unlab = state["dataset"]["train"]["unlabelled"]
        assert len(lab) == 4 + 3 * rounds_done
        assert set(lab).isdisjoint(unlab) and len(set(lab)) == len(lab)
        assert sorted(lab + unlab) == list(range(16))
    assert three["dataset"]["train"]["labelled"][:10] == \
        two["dataset"]["train"]["labelled"]
    assert three["checkpoint"].startswith(os.path.join(log, "iter-2"))
    assert os.path.exists(three["checkpoint"])
    for sub in ("pretrain", "iter-1", "iter-2"):
        assert checkpoint.latest_checkpoint(os.path.join(log, sub))
    pseudo = os.listdir(os.path.join(log, "images"))
    assert any(f.startswith("pseudo-iter1-") for f in pseudo)


def test_records_match_the_root_cli(rounds):
    _, _, _, records = rounds
    want = _root_cli_records()
    assert set(want) == {"al_train_iter", "al_train", "al_test",
                         "al_confidence", "al_timing", "al_coreset"}
    assert want["al_timing"] >= {"train_s", "restore_s", "test_s",
                                 "score_select_s", "round_s"}
    # al_coreset is core-set selection's (test_coreset_round)
    assert {r["split"] for r in records} == set(want) - {"al_coreset"}
    for r in records:
        assert set(r) == want[r["split"]], r["split"]
    timing = [r for r in records if r["split"] == "al_timing"]
    assert [(t["round"], t["labelled"]) for t in timing] == \
        [(0, 4), (1, 7), (2, 10)]
    for t in timing:
        assert t["round_s"] >= t["train_s"] > 0
    tests = [r["labelled"] for r in records if r["split"] == "al_test"]
    assert tests == [4, 7, 10]
    hists = [r for r in records if r["split"] == "al_confidence"]
    assert [sum(h["histogram"]) for h in hists] == [12, 9, 6]
    assert [r["epoch"] for r in records if r["split"] == "al_train"] \
        == [1, 2, 3]
    losses = [r["loss"] for r in records if r["split"] == "al_train_iter"]
    assert all(np.isfinite(losses))


def test_random_baseline_scores_nothing(records, tmp_path, monkeypatch):
    def no_pool_pass(*args, **kwargs):
        raise AssertionError("the baseline ran the pool pass")

    monkeypatch.setattr(al, "score_pool", no_pool_pass)
    log = tmp_path / "log"
    assert _run(records, log, _conf(str(tmp_path), "baseline", 1, -3)) == 0
    state = _state(log)
    lab = state["dataset"]["train"]["labelled"]
    assert len(lab) == 7 and set(lab).isdisjoint(
        state["dataset"]["train"]["unlabelled"])
    assert "al_confidence" not in {r["split"] for r in _records(log)}


def test_reinitialize_output_layer(records, rounds, tmp_path, monkeypatch):
    log, _, _, _ = rounds
    best = checkpoint.latest_checkpoint(os.path.join(log, "pretrain"))
    seen = []
    reinit = checkpoint.reinitialize_final_layer

    def spy(state, model, generator):
        before = {k: v.clone() for k, v in model.state_dict().items()}
        reinit(state, model, generator)
        seen.append([k for k, v in model.state_dict().items()
                     if not torch.equal(v, before[k])])
        return state

    monkeypatch.setattr(checkpoint, "reinitialize_final_layer", spy)
    new_log = tmp_path / "log"
    assert _run(records, new_log, _conf(str(tmp_path), "r", 1), "-c", best,
                "-r") == 0
    assert seen == [["Final.deconv.weight"]]
    step = torch.load(best, weights_only=True)["step"]
    first = [r for r in _records(new_log) if r["split"] == "al_train_iter"]
    assert first[0]["step"] == step + 1
    assert _state(new_log)["iteration"] == 1


def test_size_buckets_keep_the_selection(tmp_path):
    rng = np.random.default_rng(1)
    files = []
    for i in range(12):
        files.append(tmp_path / f"{i:02d}.tfrecord")
        _write(files[-1], rng, HW if i % 2 else (2 * HW[0], 2 * HW[1]),
               f"m{i}")
    train_loader = loader.RecordLoader([str(f) for f in files], 4,
                                       min_hw=HW)
    model = ENet(19)
    score_step = make_score_step(model, 19, "entropy")
    got = {}
    for knob in ("auto", 0):
        plan = al.rank_plan(train_loader, 4, HW, knob)
        assert len(plan) == (2 if knob == "auto" else 1)
        conf = al.score_pool(score_step, plan, 12, (13, 0), HW, 3, "cpu")
        got[knob] = (conf, al.select_lowest(conf, np.arange(2, 12), 4)[0])
    np.testing.assert_allclose(got["auto"][0], got[0][0], rtol=0, atol=1e-7)
    assert got["auto"][0].min() > 0
    np.testing.assert_array_equal(got["auto"][1], got[0][1])


def test_default_device_needs_a_card(records, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = al.parse_args(["cityscapes", "-d", str(records), "-l",
                          str(tmp_path / "l"), "-p",
                          _conf(str(tmp_path), "d")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        al.main(args)


def _one_round(records, tmp_path, caplog, **over):
    log = tmp_path / "log"
    with caplog.at_level("INFO"):
        assert _run(records, log, _conf(str(tmp_path), "one", 1,
                                        num_validation=0, **over)) == 0
    state = _state(log)
    lab = state["dataset"]["train"]["labelled"]
    assert state["iteration"] == 1
    assert len(lab) == 7 and len(set(lab)) == 7
    assert set(lab).isdisjoint(state["dataset"]["train"]["unlabelled"])
    return caplog.text, _records(log)


def test_bald_round(records, tmp_path, caplog):
    want = _root_cli_records()
    text, records_ = _one_round(records, tmp_path, caplog,
                                active_learning__measure="bald",
                                active_learning__mc_passes=3)
    assert "BALD acquisition: 3 MC-dropout passes" in text
    hists = [r for r in records_ if r["split"] == "al_confidence"]
    assert len(hists) == 1 and sum(hists[0]["histogram"]) == 12
    assert 0.0 < hists[0]["mean"] <= 1.0
    assert "al_coreset" not in {r["split"] for r in records_}
    for r in records_:
        assert set(r) == want[r["split"]], r["split"]


def test_coreset_round(records, tmp_path, caplog):
    want = _root_cli_records()
    text, records_ = _one_round(records, tmp_path, caplog,
                                active_learning__selection="coreset")
    assert "Core-set (k-center greedy) selection enabled" in text
    core = [r for r in records_ if r["split"] == "al_coreset"]
    assert len(core) == 1 and core[0]["selected"] == 3
    assert set(core[0]) == want["al_coreset"]
    assert 0.0 < core[0]["min_dist_mean"] <= core[0]["min_dist_max"]
    assert "al_confidence" not in {r["split"] for r in records_}


def test_bald_needs_active_dropout(records, tmp_path):
    log = tmp_path / "l"
    args = al.parse_args(["cityscapes", "-d", str(records), "-l", str(log),
                          "-p", _conf(str(tmp_path), "n",
                                      active_learning__measure="bald",
                                      hyperparams__dropout_rates=[0.0] * 5),
                          "--device", "cpu"])
    with pytest.raises(ValueError, match="needs a model with active "
                                         "dropout"):
        al.main(args)
    assert not log.exists()


ICNET = {"network__model": "ICNet",
         "hyperparams__softmax": {"multiscale": True, "label_smoothing": 0.0,
                                  "loginverse_scaling": 1.02}}


def test_icnet_bald_raises_before_writing(records, tmp_path):
    """The root CLI's ``ValueError`` (active_learning.py:341-346): ICNet
    has no dropout layer, whatever the conf's ``dropout_rates``."""
    log = tmp_path / "l"
    args = al.parse_args(["cityscapes", "-d", str(records), "-l", str(log),
                          "-p", _conf(str(tmp_path), "n",
                                      active_learning__measure="bald",
                                      **ICNET),
                          "--device", "cpu"])
    with pytest.raises(ValueError, match="needs a model with active "
                                         "dropout.*ICNet has none"):
        al.main(args)
    assert not log.exists()


@pytest.mark.parametrize("selection", ["uncertainty", "coreset"])
def test_icnet_round(records, tmp_path, caplog, selection):
    """One ICNet round with the entropy measure (the pool through
    ICNet's fused_score) or core-set selection (fused8's mean)."""
    want = _root_cli_records()
    text, records_ = _one_round(records, tmp_path, caplog,
                                active_learning__selection=selection,
                                **ICNET)
    splits = [r["split"] for r in records_]
    picked, other = ("al_coreset", "al_confidence")[::(
        1 if selection == "coreset" else -1)]
    assert splits.count(picked) == 1 and other not in splits
    assert splits.count("al_timing") == 1
    assert ("Core-set (k-center greedy) selection enabled" in text) \
        == (selection == "coreset")
    for r in records_:
        assert set(r) == want[r["split"]], r["split"]
    assert all(np.isfinite(r["loss"]) for r in records_
               if r["split"] == "al_train_iter")
    best = checkpoint.latest_checkpoint(str(tmp_path / "log" / "pretrain"))
    assert "Classifier.weight" in torch.load(best,
                                             weights_only=True)["model"]


@pytest.mark.parametrize("over,extra,error,match", [
    ({"network__dtype": "bfloat16"}, [], NotImplementedError, "item 2"),
    # -m stacks the records' extra modalities: RGB records have no 'nir'
    ({}, ["-m", "rgb", "nir"], ValueError, "has no 'nir' modality")])
def test_not_ported_raises(records, tmp_path, over, extra, error, match):
    dataset = "freiburg" if extra else "cityscapes"
    log = tmp_path / "l"
    args = al.parse_args([dataset, "-d", str(records), "-l", str(log),
                          "-p", _conf(str(tmp_path), "n", **over),
                          "--device", "cpu", *extra])
    with pytest.raises(error, match=match):
        al.main(args)
    # the bf16 raise comes before anything is written, the loader's after
    # state.json
    assert log.exists() == (error is ValueError)
