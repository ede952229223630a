"""The user-facing consumers of the port against the JAX package's, at
aki_tiny with the hash tokenizer's layout, fp32, on the same weights
(``from_jax_params``; the CLIs read a port run dir of them):

- the CV-Bench and yes/no helpers (prompts, letter rule, buckets, the
  MME/POPE parse and score rules, the record loader) on tables of inputs,
  and the CV-Bench report against JAX ``main``'s on the same predictions;
- ``eval_cv_bench.run_eval``, ``eval_yorn.run`` (each attention mode),
  ``predict.main``, ``AKIVLMEval.generate`` and ``DemoModel.answer``
  (greedy and beam) give the JAX counterparts' text;
- the demo's HTTP handler answers a multipart POST on 127.0.0.1.
"""

import base64
import csv
import html
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aki_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from aki_tpu.infer import demo as jax_demo
from aki_tpu.infer import eval_cv_bench as jax_cv
from aki_tpu.infer import eval_yorn as jax_yorn
from aki_tpu.infer import predict as jax_predict
from aki_tpu.infer import vlmevalkit as jax_vlm
from aki_tpu.models import configs as jax_configs
from aki_tpu.models import modeling as jax_modeling
from aki_tpu.models.common import F32 as JAX_F32
from aki_torch.convert import from_jax_params
from aki_torch.data.tokenizer import HashTokenizer
from aki_torch.infer import demo, eval_cv_bench, eval_yorn, predict, vlmevalkit
from aki_torch.models.aki import AKIModel
from aki_torch.models.common import F32
from aki_torch.models.configs import aki_tiny, config_for_tokenizer
from aki_torch.train.checkpoints import CheckpointManager

from ._jax_tiny import hash_tiny_params

MODEL_ARGS = ["--tiny", "--device", "cpu", "--dtype", "float32"]


def _png(seed: int, size=(40, 30)) -> bytes:
    from PIL import Image

    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, size[::-1] + (3,), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX parameters, the port's model on them, a port run dir of them
    (tower included), and the JAX config."""
    info = JaxHashTokenizer().info
    cfg_j = jax_configs.config_for_tokenizer(jax_configs.aki_tiny(info.vocab_size), info)
    cfg = config_for_tokenizer(aki_tiny(info.vocab_size), HashTokenizer().info)
    params = hash_tiny_params(21)
    model = AKIModel(cfg, device="cpu")
    sd = from_jax_params(params, cfg)
    model.load_state_dict(sd, strict=True)
    run_dir = tmp_path_factory.mktemp("run")
    CheckpointManager(str(run_dir)).save_weights(sd, epoch=0, step=1)
    return dict(params=jax.tree.map(jnp.asarray, params), cfg_j=cfg_j, model=model,
                run_dir=str(run_dir))


def _jax_model(weights, max_len=1024):
    return jax_modeling.AKIModel(params=weights["params"], cfg=weights["cfg_j"],
                                 tokenizer=JaxHashTokenizer(), policy=JAX_F32, max_len=max_len)


# -- helpers ------------------------------------------------------------------

@pytest.mark.parametrize("question,choices", [
    ("Which is bigger?", ["the cat", "the dog"]),
    ("Count the chairs.", ["(A) 1", "(B) 2", "(C) 3", "(D) 4", "(E) 5", "(F) 6"]),
    ("", ["x"]),
])
def test_cv_bench_prompt_matches_jax(question, choices):
    assert eval_cv_bench.render_prompt(question, choices) == \
        jax_cv.render_prompt(question, choices)
    assert eval_cv_bench.optionize_choices(choices) == jax_cv.optionize_choices(choices)


def test_cv_bench_letter_and_bucket_rules_match_jax():
    for text in ["(B)", " B. the dog", "no letter", "(A) (C)", "F", "g", "  (E", "xyz D)"]:
        assert eval_cv_bench.extract_letter(text) == jax_cv.extract_letter(text)
    assert eval_cv_bench.BUCKETS == jax_cv.BUCKETS
    for n in [0, 1, 95, 96, 97, 128, 129, 700, 1024]:
        assert eval_cv_bench.pick_bucket(n) == jax_cv.pick_bucket(n)
    for mod in (eval_cv_bench, jax_cv):
        with pytest.raises(ValueError):
            mod.pick_bucket(1025)


def test_yorn_parse_rules_match_jax():
    preds = ["Yes", " no ", "yes, it is", "no. the image shows", "Nope", "maybe yes", "unclear",
             "There is not a dog.", "Yes. No doubt about it", "it is, no,", "absolutely",
             "nothing", "", "NO", "not"]
    for p in preds:
        assert eval_yorn.mme_parse_pred(p) == jax_yorn.mme_parse_pred(p), p
        assert eval_yorn.pope_parse_pred(p) == jax_yorn.pope_parse_pred(p), p
    for q in ["Is there a dog in the image? Please answer yes or no.", "plain?"]:
        assert eval_yorn.render_prompt(q) == jax_yorn.render_prompt(q)
    assert (eval_yorn.MME_PERCEPTION, eval_yorn.MME_COGNITION) == \
        (jax_yorn.MME_PERCEPTION, jax_yorn.MME_COGNITION)


def test_yorn_scores_match_jax():
    rng = np.random.RandomState(0)
    cats = ["existence", "count", "code_reasoning", "OCR"]
    recs = [{"image_key": f"{i // 2}.jpg", "answer": ["Yes", "No"][i % 2],
             "category": cats[(i // 2) % 4], "question": "", "index": i} for i in range(40)]
    words = ["yes", "no", "Yes.", "No, not", "maybe", "nope", "yes, no"]
    preds = [words[j] for j in rng.randint(0, len(words), len(recs))]
    assert eval_yorn.score_mme(recs, preds) == jax_yorn.score_mme(recs, preds)
    pope = [{"answer": a, "category": c} for a, c in zip(
        rng.choice(["yes", "no"], 30), rng.choice(["adversarial", "popular", ""], 30))]
    assert eval_yorn.score_pope(pope, preds[:30]) == jax_yorn.score_pope(pope, preds[:30])


def test_load_records_and_pixels_match_jax(tmp_path):
    b64 = base64.b64encode(_png(1)).decode()
    tsv = tmp_path / "mme.tsv"
    tsv.write_text(
        "index\timage\timage_path\tquestion\tanswer\tcategory\n"
        f"0\t{b64}\timgs/a.jpg\tIs it red? Please answer yes or no.\tYes\tcolor\n"
        f"1\t{b64}\t\tIs it blue? Please answer yes or no.\t No \tcolor\n")
    jl = tmp_path / "pope.jsonl"
    jl.write_text(json.dumps({"index": 0, "image": b64, "question": "Is there a dog?",
                              "answer": "no", "category": "adversarial"}) + "\n")
    for path, kw in ((tsv, dict(image_root="/data")), (jl, {}), (tsv, dict(limit=1))):
        got = eval_yorn.load_records(str(path), **kw)
        assert got == jax_yorn.load_records(str(path), **kw)
    rec = eval_yorn.load_records(str(jl))[0]
    assert np.array_equal(np.asarray(eval_yorn.record_pixels(rec)),
                          np.asarray(jax_yorn.record_pixels(rec)))
    (tmp_path / "none.jsonl").write_text(json.dumps({"question": "q", "answer": "yes"}) + "\n")
    with pytest.raises(ValueError, match="no image"):
        eval_yorn.load_records(str(tmp_path / "none.jsonl"))


def test_cv_bench_report_matches_jax_main(tmp_path, monkeypatch):
    """The scoring of JAX ``main`` (fed fixed predictions) and the port's
    ``score`` write the same report and rows."""
    sources = ["ADE20K", "ADE20K", "COCO", "COCO", "COCO", "Omni3D", "Omni3D", "Omni3D"]
    answers = ["A", "B", "C", "A", "B", "A", "D", "B"]
    preds = ["A", "A", "C", "A", "(B)", "A", "D", "C"]
    rows = [{"question": f"q{i}", "choices": ["x", "y"], "image": None, "answer": f"({a})",
             "source": s} for i, (s, a) in enumerate(zip(sources, answers))]

    import datasets

    monkeypatch.setattr(datasets, "load_dataset", lambda *a, **k: rows)
    monkeypatch.setattr(jax_cv, "load_params", lambda *a, **k: None)
    monkeypatch.setattr(jax_cv, "run_eval", lambda *a, **k: preds)
    jax_cv.main(["--data", "unused", "--tiny", "--out", str(tmp_path)])
    samples = [{"answer": a, "source": s} for s, a in zip(sources, answers)]
    results, report = eval_cv_bench.score(samples, preds)
    assert report == (tmp_path / "report.txt").read_text()
    with (tmp_path / "predictions.csv").open() as f:
        assert [{k: str(v) for k, v in r.items()} for r in results] == list(csv.DictReader(f))
    # 2D is the mean of ADE20K (1/2) and COCO (2/3), not the pooled 3/5
    assert report.startswith("CV-Bench Accuracy: 62.50\n2D Accuracy: 58.33\n")


# -- outputs --------------------------------------------------------------------

def _cv_samples(seed=3):
    """Prompts in two buckets (96 and 128 tokens), five samples."""
    tok = HashTokenizer()
    rng = np.random.RandomState(seed)
    samples = []
    for i, extra in enumerate([0, 3, 40, 55, 1]):
        q = " ".join(f"w{j}" for j in rng.randint(0, 50, 5 + extra))
        samples.append({"ids": tok.encode(eval_cv_bench.render_prompt(q, ["red", "blue"])),
                        "image": rng.randn(28, 28, 3).astype(np.float32)})
    assert {eval_cv_bench.pick_bucket(len(s["ids"])) for s in samples} == {96, 128}
    return samples


@pytest.mark.parametrize("attn_mode", [None, "causal"])
def test_run_eval_matches_jax(weights, attn_mode):
    samples = _cv_samples()
    want = jax_cv.run_eval(weights["params"], weights["cfg_j"], JaxHashTokenizer(), samples,
                           batch_size=2, max_new_tokens=3, policy=JAX_F32,
                           attn_mode=attn_mode, warmup=False)
    got = eval_cv_bench.run_eval(weights["model"], HashTokenizer(), samples, batch_size=2,
                                 max_new_tokens=3, policy=F32, attn_mode=attn_mode)
    assert got == want and all(isinstance(p, str) and p for p in got)


@pytest.fixture(scope="module")
def pope_tsv(tmp_path_factory):
    d = tmp_path_factory.mktemp("pope")
    rows = ["index\timage\tquestion\tanswer\tcategory"]
    for i in range(3):
        b64 = base64.b64encode(_png(10 + i)).decode()
        rows.append(f"{i}\t{b64}\tIs there a thing {i}? Please answer yes or no.\t"
                    f"{'yes' if i % 2 else 'no'}\tpopular")
    (d / "pope.tsv").write_text("\n".join(rows) + "\n")
    return d / "pope.tsv"


@pytest.mark.parametrize("attn_mode", ["mma", "dot", "causal"])
def test_yorn_run_matches_jax(weights, pope_tsv, attn_mode):
    recs = eval_yorn.load_records(str(pope_tsv))
    want = jax_yorn.run(recs, weights["params"], weights["cfg_j"], JaxHashTokenizer(),
                        batch_size=2, max_new_tokens=3, attn_mode=attn_mode, warmup=False,
                        policy=JAX_F32)
    got = eval_yorn.run(recs, weights["model"], HashTokenizer(), batch_size=2,
                        max_new_tokens=3, attn_mode=attn_mode, policy=F32)
    assert got == want


def test_yorn_main_end_to_end(weights, pope_tsv, tmp_path):
    eval_yorn.main(["--benchmark", "pope", "--data", str(pope_tsv), "--checkpoint",
                    weights["run_dir"], "--batch", "2", "--max-new-tokens", "3",
                    "--out", str(tmp_path), "--attn-mode", "dot", *MODEL_ARGS])
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["overall"]["n"] == 3
    preds = [json.loads(x)["pred"] for x in
             (tmp_path / "predictions.jsonl").read_text().splitlines()]
    recs = eval_yorn.load_records(str(pope_tsv))
    assert preds == eval_yorn.run(recs, weights["model"], HashTokenizer(), batch_size=2,
                                  max_new_tokens=3, attn_mode="dot", policy=F32)
    assert report == eval_yorn.score_pope(recs, preds)


def test_predict_main_matches_jax(weights, tmp_path, monkeypatch):
    reqs = []
    for i in range(3):
        (tmp_path / f"{i}.png").write_bytes(_png(30 + i))
        reqs.append(json.dumps({"image": str(tmp_path / f"{i}.png"),
                                "question": f"what is {i} here ?", "id": f"r{i}"}))
    reqs.append(json.dumps({"image": str(tmp_path / "0.png"), "question": "and this ?"}))
    (tmp_path / "in.jsonl").write_text("\n".join(reqs) + "\n")
    argv = ["--input", str(tmp_path / "in.jsonl"), "--slots", "2", "--max-new-tokens", "4",
            "--max-len", "256", "--prompt-bucket", "96", "--tiny"]
    monkeypatch.setattr(jax_modeling.AKIModel, "from_pretrained",
                        classmethod(lambda cls, *a, **k: _jax_model(weights)))
    engines = []

    class ClosedAfter(jax_predict.ServingEngine):
        """JAX ``predict.main`` leaves its engine's uploader threads running."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

    monkeypatch.setattr(jax_predict, "ServingEngine", ClosedAfter)
    try:
        jax_predict.main(argv + ["--output", str(tmp_path / "want.jsonl")])
    finally:
        for eng in engines:
            eng.close()
    predict.main(argv + ["--output", str(tmp_path / "got.jsonl"), "--checkpoint",
                         weights["run_dir"], "--device", "cpu", "--dtype", "float32"])
    got = (tmp_path / "got.jsonl").read_text().splitlines()
    assert got == (tmp_path / "want.jsonl").read_text().splitlines()
    assert [json.loads(x)["id"] for x in got] == ["r0", "r1", "r2", 3]


def test_vlmevalkit_matches_jax(weights, tmp_path):
    (tmp_path / "x.png").write_bytes(_png(40))
    want = jax_vlm.AKIVLMEval.__new__(jax_vlm.AKIVLMEval)   # its own init draws weights
    want.model, want.max_new_tokens = _jax_model(weights, max_len=96), 4
    got = vlmevalkit.AKIVLMEval(weights["run_dir"], tiny=True, max_new_tokens=4, max_len=96,
                                device="cpu", dtype=torch.float32)
    assert got.use_custom_prompt("MMBench") is False and got.INTERLEAVE is False
    pixels = np.random.RandomState(2).randn(28, 28, 3).astype(np.float32)
    for message in ([{"type": "image", "value": str(tmp_path / "x.png")},
                     {"type": "text", "value": "What color is this?"},
                     {"type": "text", "value": "Answer briefly."}],
                    [{"type": "image", "value": _png(41)}, {"type": "text", "value": "Hm?"}],
                    [{"type": "image", "value": pixels}, {"type": "text", "value": "Array?"}],
                    [{"type": "text", "value": "No image at all?"}]):
        assert got.generate(message) == want.generate(message)


@pytest.fixture(scope="module")
def demo_models(weights):
    def make(**kw):
        want = jax_demo.DemoModel(None, None, tiny=True, max_new_tokens=5, **kw)
        want.params, want.policy = weights["params"], JAX_F32
        got = demo.DemoModel(weights["run_dir"], None, tiny=True, max_new_tokens=5,
                             device="cpu", dtype=torch.float32, **kw)
        return got, want

    return {"greedy": make(), "beam": make(num_beams=2, no_repeat_ngram_size=2)}


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_demo_answer_matches_jax(demo_models, mode):
    got, want = demo_models[mode]
    for seed in (50, 51):
        data = _png(seed)
        assert got.answer(data, "What is in this image?") == \
            want.answer(data, "What is in this image?")


def test_demo_sampling_draws_from_a_seeded_generator(demo_models):
    got, _ = demo_models["greedy"]
    data = _png(52)
    np.random.seed(5)
    a = got.answer(data, "q", temperature=1.0)
    np.random.seed(5)
    assert got.answer(data, "q", temperature=1.0) == a


def _multipart(fields: dict[str, tuple[str | None, bytes]]) -> tuple[str, bytes]:
    boundary = "----akiboundary7"
    parts = []
    for name, (filename, data) in fields.items():
        disp = f'form-data; name="{name}"' + (f'; filename="{filename}"' if filename else "")
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n".encode()
                     + data + b"\r\n")
    return (f"multipart/form-data; boundary={boundary}",
            b"".join(parts) + f"--{boundary}--\r\n".encode())


def test_demo_http_answers_a_multipart_post(demo_models):
    model, _ = demo_models["greedy"]
    data = _png(53)
    ctype, body = _multipart({"image": ("x.png", data), "question": (None, b"What is it?")})
    assert demo.parse_form(ctype, body) == {"image": data, "question": b"What is it?"}
    server = demo.make_server(model, 0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}/generate"
        with urllib.request.urlopen(url, timeout=60) as r:
            assert r.status == 200 and b"<form" in r.read()
        req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=60) as r:
            page = r.read().decode()
        assert f"<pre>{html.escape(model.answer(data, 'What is it?'))}</pre>" in page
        bad = urllib.request.Request(url, data=b"x", headers={"Content-Type": "text/plain"})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 500
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
