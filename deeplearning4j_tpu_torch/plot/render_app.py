"""Interactive embedding render web app.

Capability match of the reference's dropwizard render application
(``deeplearning4j-nlp/.../plot/dropwizard/RenderApplication.java:21`` with
``ApiResource``/``RenderResource``: a small web app that serves 2-D word
coordinates as JSON and a page that draws them).  Zero-dependency
equivalent: a stdlib HTTP server with one embedded HTML/canvas page —
pan/zoom scatter, hover tooltips, substring search — reading
``/api/coords``.  Feed it t-SNE output (``plot/tsne.py``) over a vocab, or
any (words, (N, 2) coords) pair; ``update()`` republishes live during
training.

Port of ``deeplearning4j_tpu/plot/render_app.py``: the server is host code,
copied; :func:`render_word_vectors` runs its t-SNE on the card unless
``device`` names another.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np

__all__ = ["EmbeddingRenderServer", "render_word_vectors"]

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Embedding render</title>
<style>
 body { margin:0; font:13px system-ui, sans-serif; }
 #bar { padding:6px 10px; background:#222; color:#eee; display:flex; gap:10px;
        align-items:center; }
 #bar input { padding:3px 6px; border-radius:3px; border:none; }
 #tip { position:fixed; pointer-events:none; background:#222; color:#fff;
        padding:2px 7px; border-radius:3px; display:none; }
 canvas { display:block; cursor:grab; }
</style></head><body>
<div id="bar"><b>embedding render</b>
 <input id="q" placeholder="search word..."/>
 <span id="n"></span>
 <span style="opacity:.6">drag to pan &middot; wheel to zoom</span></div>
<div id="tip"></div><canvas id="c"></canvas>
<script>
const cv = document.getElementById('c'), tip = document.getElementById('tip');
const ctx = cv.getContext('2d');
let pts = [], view = {x:0, y:0, s:1}, drag = null, query = '';
function resize(){ cv.width = innerWidth; cv.height = innerHeight - 34; draw(); }
addEventListener('resize', resize);
function fit(){
  if (!pts.length) return;
  const xs = pts.map(p=>p.x), ys = pts.map(p=>p.y);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const s = 0.9 * Math.min(cv.width/(x1-x0+1e-9), cv.height/(y1-y0+1e-9));
  view = {s, x: cv.width/2 - s*(x0+x1)/2, y: cv.height/2 - s*(y0+y1)/2};
}
function toScreen(p){ return [view.x + view.s*p.x, view.y + view.s*p.y]; }
function draw(){
  ctx.clearRect(0,0,cv.width,cv.height);
  for (const p of pts){
    const [sx, sy] = toScreen(p);
    if (sx < -20 || sy < -20 || sx > cv.width+20 || sy > cv.height+20) continue;
    const hit = query && p.word.includes(query);
    ctx.fillStyle = hit ? '#d33' : '#4477cc';
    ctx.beginPath(); ctx.arc(sx, sy, hit ? 5 : 3, 0, 7); ctx.fill();
    if (view.s > 40 || hit){
      ctx.fillStyle = '#333'; ctx.fillText(p.word, sx+6, sy+3);
    }
  }
}
cv.onmousedown = e => drag = {x:e.clientX, y:e.clientY};
addEventListener('mouseup', () => drag = null);
cv.onmousemove = e => {
  if (drag){
    view.x += e.clientX - drag.x; view.y += e.clientY - drag.y;
    drag = {x:e.clientX, y:e.clientY}; draw(); return;
  }
  let best = null, bd = 144;
  for (const p of pts){
    const [sx, sy] = toScreen(p);
    const d = (sx-e.clientX)**2 + (sy-(e.clientY-34))**2;
    if (d < bd){ bd = d; best = p; }
  }
  if (best){
    tip.style.display = 'block';
    tip.style.left = (e.clientX+12)+'px'; tip.style.top = (e.clientY+12)+'px';
    tip.textContent = best.word;
  } else tip.style.display = 'none';
};
cv.onwheel = e => {
  e.preventDefault();
  const k = Math.exp(-e.deltaY * 0.001);
  view.x = e.clientX - k*(e.clientX - view.x);
  view.y = (e.clientY-34) - k*((e.clientY-34) - view.y);
  view.s *= k; draw();
};
document.getElementById('q').oninput = e => { query = e.target.value; draw(); };
async function load(){
  const r = await fetch('api/coords');
  pts = await r.json();
  document.getElementById('n').textContent = pts.length + ' words';
  resize(); fit(); draw();
}
load(); setInterval(load, 5000);
</script></body></html>
"""


class EmbeddingRenderServer:
    """Serve an interactive 2-D embedding scatter.

    ``/`` — the render page; ``/api/coords`` — ``[{word, x, y}, ...]``;
    ``update(words, coords)`` republishes (the page polls every 5 s, so a
    training loop can stream its t-SNE snapshots like the reference's
    ``plotVocab`` + render app pair).
    """

    def __init__(self, words: Sequence[str], coords: np.ndarray,
                 host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        self._payload = b"[]"
        self.update(words, coords)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body, ctype = _PAGE.encode(), "text/html; charset=utf-8"
                elif self.path == "/api/coords":
                    with outer._lock:
                        body = outer._payload
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def update(self, words: Sequence[str], coords: np.ndarray) -> None:
        coords = np.asarray(coords, np.float64)
        if coords.shape != (len(words), 2):
            raise ValueError(f"coords must be ({len(words)}, 2), "
                             f"got {coords.shape}")
        payload = [{"word": w, "x": float(x), "y": float(y)}
                   for w, (x, y) in zip(words, coords)]
        with self._lock:
            self._payload = json.dumps(payload).encode()

    def start(self) -> "EmbeddingRenderServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def render_word_vectors(model, *, perplexity: float = 15.0,
                        max_words: int = 500, seed: int = 0,
                        host: str = "127.0.0.1", port: int = 0,
                        n_iter: int = 300,
                        device=None) -> EmbeddingRenderServer:
    """One-call path from a trained embedding model (``Word2Vec``/``Glove``
    — anything with ``.vocab.words()`` and ``.get_word_vector``) to a live
    render server (the ``InMemoryLookupTable.plotVocab`` -> dropwizard
    flow): t-SNE the top ``max_words`` vectors to 2-D on ``device`` (the
    card by default) and serve them."""
    from .tsne import Tsne

    words = list(model.vocab.words())[:max_words]
    vecs = np.stack([np.asarray(model.get_word_vector(w)) for w in words])
    coords = Tsne(n_iter=n_iter, perplexity=min(perplexity,
                                                max(2.0, len(words) / 4)),
                  seed=seed, device=device).fit_transform(vecs)
    return EmbeddingRenderServer(words, coords, host=host, port=port).start()
