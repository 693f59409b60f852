"""``python -m paddle_tpu_torch serve-fleet`` on the CPU: the router over
port replicas, by pipe and by socket.

The width-16 seqToseq generation config of ``tests/test_torch_serve_cli.py``
at the port's ``init_params(seed=1)``:

- a 2-replica pipe fleet answers exactly what a single ``serve`` answers;
- a replica that dies mid-run (an injected ``serve.crash`` at its 2nd
  collect boundary) still leaves every request answered exactly once, in
  submission order, with rc 0 (the JAX package's
  ``tests/test_serve_fleet.py`` acceptance scenario);
- two ``serve --listen`` servers behind a ``--replica_addr`` socket fleet
  answer what the pipe fleet answers (``tests/test_transport.py``).
"""

import json
import os
import subprocess
import sys

import pytest

from paddle_tpu_torch.utils import concurrency as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SERVE_CONFIG = """
import sys
sys.path.insert(0, {demo!r})
from paddle.trainer_config_helpers import *
from seqToseq_net import gru_encoder_decoder

settings(batch_size=2, learning_rate=1e-3, learning_method=AdamOptimizer())
gru_encoder_decoder(source_dict_dim=50, target_dict_dim=50,
                    is_generating=True, word_vector_dim=16,
                    encoder_size=16, decoder_size=16, beam_size=1,
                    max_length=6)
"""

# one thread a process: the servers run beside other test workers
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
SERVE = ["--use_tpu=false", "--serve_slots=2", "--serve_prompt_tokens=4",
         "--serve_decode_block=1"]
TIMEOUT = 120
IDS = [f"c{i}" for i in range(8)]
STDIN = "\n".join(json.dumps({"id": rid, "prompt": [4 + i, 7, 3][: 1 + i % 3],
                              "max_new_tokens": 2 + i % 3})
                  for i, rid in enumerate(IDS)) + "\n"


def port_cmd(*args):
    return [sys.executable, "-m", "paddle_tpu_torch", *args]


def answers(stdout):
    out = []
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            doc = json.loads(line)
            if "outcome" in doc:
                out.append(doc)
    return out


# the port's init_params(seed=1) as pass-00000, written by a fresh process:
# a config parsed here would take its layer names from what earlier tests
# in this worker left in the parser's naming context
WRITE_PASS0 = """
import sys
from paddle_tpu_torch.config import parse_config
from paddle_tpu_torch.graph import GradientMachine
from paddle_tpu_torch.trainer import checkpoint as ckpt

gm = GradientMachine(parse_config(sys.argv[1]).model_config, device="cpu")
ckpt.save_checkpoint(sys.argv[2], 0, gm.init_params(seed=1))
"""


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("serve_fleet")
    cfg = ws / "serve_conf.py"
    cfg.write_text(SERVE_CONFIG.format(demo=os.path.join(REPO, "demo", "seqToseq")))
    out = subprocess.run([sys.executable, "-c", WRITE_PASS0, str(cfg), str(ws / "ckpt")],
                         capture_output=True, text=True, timeout=TIMEOUT, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    return ws, [f"--config={cfg}", f"--init_model_path={ws / 'ckpt' / 'pass-00000'}"]


@pytest.fixture(scope="module")
def single(ws):
    """One ``serve``'s answers: the reference of every fleet here."""
    ws, model = ws
    out = subprocess.run(port_cmd("serve", *model, *SERVE), input=STDIN, capture_output=True,
                         text=True, timeout=TIMEOUT, env=ENV, cwd=str(ws))
    assert out.returncode == 0, out.stderr[-3000:]
    got = answers(out.stdout)
    assert [d["id"] for d in got] == IDS and all(d["outcome"] == "ok" for d in got)
    return {d["id"]: d["tokens"] for d in got}


def _fleet(ws, model, name, env=ENV, extra=()):
    out = subprocess.run(
        port_cmd("serve-fleet", *model, *SERVE, "--fleet_replicas=2",
                 f"--fleet_status_dir={ws / name}", "--restart_base_delay=0.01", *extra),
        input=STDIN, capture_output=True, text=True, timeout=TIMEOUT, env=env, cwd=str(ws))
    assert out.returncode == 0, (out.returncode, out.stderr[-4000:])
    got = answers(out.stdout)
    assert [d["id"] for d in got] == IDS, ([d["id"] for d in got], out.stderr[-3000:])
    assert all(d["outcome"] == "ok" for d in got), got
    return {d["id"]: d["tokens"] for d in got}, out


def test_pipe_fleet_answers_equal_a_single_serve(ws, single):
    ws, model = ws
    got, _ = _fleet(ws, model, "fleet_pipe")
    assert got == single


def test_fleet_kills_one_replica_every_request_answered(ws, single):
    """Replica 0 dies at its 2nd collect boundary: the router re-offers
    its journaled unanswered requests to replica 1 and restarts it on
    budget; every id is answered once, in order, as a single serve
    answers it, and the run_end record counts the death."""
    from paddle_tpu_torch.observability.analyze import load_run

    ws, model = ws
    run_dir = ws / "kill_run"
    env = dict(ENV, PADDLE_TPU_FLEET_CHILD_FAULTS_0="serve.crash=exit:3@2")
    got, _ = _fleet(ws, model, "fleet_kill", env=env,
                    extra=("--restart_budget=1", f"--metrics_path={run_dir}"))
    assert got == single
    recs = [r for rs in load_run(str(run_dir)).values() for r in rs]
    assert recs and recs[-1]["kind"] == "run_end", recs[-1:]
    counters = recs[-1].get("counters") or {}
    assert counters.get("fleet.deaths", 0) >= 1, counters
    assert counters.get("fleet.routed", 0) >= len(IDS), counters
    assert (ws / "fleet_kill" / "replica-0.journal.jsonl").exists()


def _drain(pipe, sink):
    t = cc.Thread(target=lambda: sink.extend(pipe), daemon=True)
    t.start()
    return t


def _listen_server(ws, model):
    """One ``serve --listen 127.0.0.1:0``; returns (proc, address) once it
    prints the address it bound."""
    proc = subprocess.Popen(port_cmd("serve", *model, *SERVE, "--listen=127.0.0.1:0"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=ENV, cwd=str(ws))
    marker = "# paddle serve: listening on "
    errs, addr = [], None
    deadline = cc.monotonic() + TIMEOUT
    while cc.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        errs.append(line)
        if line.startswith(marker):
            addr = line[len(marker):].strip()
            break
    assert addr, f"the server never printed its address: {''.join(errs)}"
    _drain(proc.stderr, errs)
    _drain(proc.stdout, errs)
    return proc, addr


def test_socket_fleet_answers_equal_the_pipe_fleet(ws, single):
    """The transport moves bytes, never numerics: two listening servers
    behind a socket fleet answer as the pipe fleet (and a single serve)
    does."""
    ws, model = ws
    servers = [_listen_server(ws, model) for _ in range(2)]
    try:
        out = subprocess.run(
            port_cmd("serve-fleet", *[f"--replica_addr={a}" for _, a in servers],
                     f"--fleet_status_dir={ws / 'fleet_sock'}"),
            input=STDIN, capture_output=True, text=True, timeout=TIMEOUT, env=ENV,
            cwd=str(ws))
        assert out.returncode == 0, out.stderr[-4000:]
        got = answers(out.stdout)
        assert sorted(d["id"] for d in got) == sorted(IDS)
        assert all(d["outcome"] == "ok" for d in got), got
        assert {d["id"]: d["tokens"] for d in got} == single
    finally:
        for proc, _ in servers:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
