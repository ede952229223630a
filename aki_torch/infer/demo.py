"""Local demo: CLI chat and a minimal web UI on ``http.server`` (counterpart of
``aki_tpu/infer/demo.py``).

Counterpart of the reference's ``local_demo.py`` (Gradio): load a
checkpoint, take an image and a question, generate with the MMA engine
(greedy, sampled, or beam search). The web page is a dependency-free
single-file server; the prompt is the eval/demo chat prompt. The form's
multipart body is parsed with the standard ``email`` parser (``cgi`` leaves
Python in 3.13).

Usage:
    python -m aki_torch.infer.demo --checkpoint runs/sft [--tiny] \
        [--serve PORT | --image x.jpg --question "..."]
"""

from __future__ import annotations

import argparse
import html
from email import policy as email_policy
from email.parser import BytesParser
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch

from ..data.images import decode_image, preprocess
from ..models.modeling import AKI, chat_prompt
from .engine import generate
from .sampling import SamplingConfig

MAX_LEN = 1024

PAGE = """<!doctype html><title>aki_torch demo</title>
<h2>aki_torch — AKI multimodal demo</h2>
<form method=post enctype=multipart/form-data action=/generate>
<p><input type=file name=image accept=image/*></p>
<p><textarea name=question rows=3 cols=60>What is in this image?</textarea></p>
<p><input type=submit value=Generate></p></form>"""


class DemoModel:
    def __init__(self, checkpoint, tokenizer_path, tiny=False, max_new_tokens=256,
                 num_beams=1, length_penalty=1.0, no_repeat_ngram_size=0, device="cuda",
                 dtype=torch.bfloat16):
        self.aki = AKI.from_pretrained(checkpoint, tokenizer_path=tokenizer_path, tiny=tiny,
                                       device=device, dtype=dtype)
        self.tokenizer = self.aki.tokenizer
        self.cfg = self.aki.cfg
        self.max_new_tokens = max_new_tokens
        self.num_beams = num_beams
        self.length_penalty = length_penalty
        self.no_repeat_ngram_size = no_repeat_ngram_size

    def answer(self, image_bytes: bytes, question: str, temperature: float = 0.0) -> str:
        img = preprocess(decode_image(image_bytes), self.cfg.siglip.image_size)
        ids = self.tokenizer.encode(chat_prompt(question))  # add_special_tokens=False
        model, pol = self.aki.model, self.aki.policy
        valid = np.ones((1, len(ids)), np.int32)
        if self.num_beams > 1:
            # HF-generate parity surface (flamingo.py:156-162): beam search
            # with length penalty / ngram banning
            from .beam import generate_beam

            tokens, num, _ = generate_beam(
                model, [ids], img[None], valid, max_new_tokens=self.max_new_tokens,
                max_len=MAX_LEN, num_beams=self.num_beams, eos_id=self.tokenizer.info.end_id,
                length_penalty=self.length_penalty,
                no_repeat_ngram_size=self.no_repeat_ngram_size, policy=pol,
                device=model.device)
            tokens, num = tokens[:, 0], num[:, 0]
        else:
            # the draw's seed comes from numpy's global state, as the JAX
            # demo seeds its PRNGKey
            gen = torch.Generator(device=model.device).manual_seed(
                int(np.random.randint(2 ** 31)))
            tokens, num = generate(
                model, [ids], img[None], valid, self.max_new_tokens, MAX_LEN,
                eos_id=self.tokenizer.info.end_id,
                sampling=SamplingConfig(temperature=temperature), generator=gen,
                policy=pol, device=model.device)
        return self.tokenizer.decode(tokens[0, : int(num[0])].tolist())


def parse_form(content_type: str, body: bytes) -> dict[str, bytes]:
    """The fields of a ``multipart/form-data`` body, by name."""
    msg = BytesParser(policy=email_policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        raise ValueError("expected a multipart/form-data body")
    return {part.get_param("name", header="content-disposition"):
            part.get_payload(decode=True) for part in msg.iter_parts()}


def answer_form(model: DemoModel, content_type: str, body: bytes) -> tuple[int, str]:
    """(status, page) of one POSTed form: the answer, or the error."""
    try:
        form = parse_form(content_type, body)
        answer = model.answer(form["image"], form.get("question", b"").decode())
    except Exception as e:  # noqa: BLE001 — the page reports any failure
        return 500, PAGE + f"<pre>error: {html.escape(str(e))}</pre>"
    return 200, PAGE + f"<h3>Answer</h3><pre>{html.escape(answer)}</pre>"


def make_server(model: DemoModel, port: int, host: str = "0.0.0.0") -> HTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, page: str) -> None:
            data = page.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._send(200, PAGE)

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self._send(*answer_form(model, self.headers.get("Content-Type", ""), body))

        def log_message(self, *a):
            pass

    return HTTPServer((host, port), Handler)


def serve(model: DemoModel, port: int) -> None:
    server = make_server(model, port)
    print(f"serving on http://0.0.0.0:{server.server_port}")
    with server:
        server.serve_forever()


def main(argv=None):
    from .eval_cv_bench import DTYPES, add_model_args

    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--serve", type=int, default=None)
    ap.add_argument("--image", default=None)
    ap.add_argument("--question", default="What is in this image?")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    # HF-generate parity knobs (reference generate(), flamingo.py:156-162)
    ap.add_argument("--num-beams", type=int, default=1)
    ap.add_argument("--length-penalty", type=float, default=1.0)
    ap.add_argument("--no-repeat-ngram-size", type=int, default=0)
    args = ap.parse_args(argv)

    model = DemoModel(args.checkpoint, args.tokenizer, tiny=args.tiny,
                      max_new_tokens=args.max_new_tokens, num_beams=args.num_beams,
                      length_penalty=args.length_penalty,
                      no_repeat_ngram_size=args.no_repeat_ngram_size, device=args.device,
                      dtype=DTYPES[args.dtype])
    if args.serve:
        serve(model, args.serve)
        return
    if not args.image:
        ap.error("--image is required without --serve")
    with open(args.image, "rb") as f:
        print(model.answer(f.read(), args.question, args.temperature))


if __name__ == "__main__":
    main()
