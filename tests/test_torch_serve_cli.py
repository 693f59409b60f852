"""``python -m paddle_tpu_torch serve`` against ``python -m paddle_tpu.cli
serve``, and the port's chaos exits, on the CPU.

Both front doors serve the JAX chaos tests' width-16 seqToseq generation
config (``tests/test_serve_resilience.py::SERVE_CONFIG``) from one
``pass-00000`` written by the JAX package, on one stdin: a line that is not
JSON, an id-less prompt, eight requests and a duplicate id under a request
journal. Their result lines must agree id for id in outcome and tokens
(the pid-salted auto ids by position), and so must their journals. Then
the JAX package's serve chaos scenarios on the port's command line: the
OOM pre-mortem (exit 20), the stall hangwatch (exit 19, forensics and the
wedged cohort's answers) and the supervised restart that answers the
journal; and ``serve-status`` / ``serve-report`` on the port's run dir.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from paddle_tpu_torch.resilience import EXIT_HANG, EXIT_OOM
from paddle_tpu_torch.resilience.supervisor import CRASH_REPORT
from paddle_tpu_torch.serving.resilience import SERVE_HANG_REPORT

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

# the JAX package's command line finds `paddle` in compat/; the port binds
# it to its own shim and needs only the repository
# (one thread a process: the servers run beside other test workers)
JAX_ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=f"{REPO}:{os.path.join(REPO, 'compat')}")
PORT_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
SERVE = ["--use_tpu=false", "--serve_slots=2", "--serve_prompt_tokens=4",
         "--serve_decode_block=1"]
TIMEOUT = 120


def port_cmd(*args):
    return [sys.executable, "-m", "paddle_tpu_torch", *args]


def jax_cmd(*args):
    return [sys.executable, "-m", "paddle_tpu.cli", *args]


# the JAX package's init_params(seed=1) as pass-00000, written by a fresh
# process: a config parsed here would take its layer names from what
# earlier tests in this worker left in the parser's naming context
WRITE_PASS0 = """
import sys
from paddle_tpu.config import parse_config
from paddle_tpu.graph import GradientMachine
from paddle_tpu.trainer import checkpoint as ckpt

gm = GradientMachine(parse_config(sys.argv[1]).model_config)
ckpt.save_checkpoint(sys.argv[2], 0, gm.init_params(seed=1))
"""


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The config, and the JAX package's ``init_params(seed=1)`` saved as
    ``pass-00000``."""
    ws = tmp_path_factory.mktemp("serve_cli")
    cfg = ws / "serve_conf.py"
    cfg.write_text(SERVE_CONFIG.format(demo=os.path.join(REPO, "demo", "seqToseq")))
    out = subprocess.run([sys.executable, "-c", WRITE_PASS0, str(cfg), str(ws / "ckpt")],
                         capture_output=True, text=True, timeout=TIMEOUT, env=JAX_ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    return ws, cfg, ws / "ckpt" / "pass-00000"


def answers(stdout):
    out = []
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            doc = json.loads(line)
            if "outcome" in doc:
                out.append(doc)
    return out


def _auto_ids_by_position(docs):
    """``req-<pid>-<n>`` -> ``req-<n>``: the pid differs between runs."""
    return [dict(d, id=re.sub(r"^req-\d+-(\d+)$", r"req-\1", d["id"])) for d in docs]


def test_serve_lines_equal_the_jax_package(ws, capsys):
    ws, cfg, ckpt = ws
    lines = ["not json", json.dumps([5, 6])]
    lines += [json.dumps({"id": f"s{i}", "prompt": [4 + i, 7, 3][: 1 + i % 3],
                          "max_new_tokens": 2 + i % 4}) for i in range(8)]
    lines.append(json.dumps({"id": "s3", "prompt": [9, 9], "max_new_tokens": 3}))
    stdin = "\n".join(lines) + "\n"
    flags = [f"--config={cfg}", f"--init_model_path={ckpt}", *SERVE]
    runs = {}
    procs = {
        "jax": subprocess.Popen(jax_cmd("serve", *flags, f"--serve_journal_path={ws / 'jax.jsonl'}"),
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=JAX_ENV, cwd=str(ws)),
        "port": subprocess.Popen(port_cmd("serve", *flags, f"--serve_journal_path={ws / 'port.jsonl'}",
                                          f"--status_path={ws / 'status.json'}",
                                          f"--metrics_path={ws / 'run'}"),
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=PORT_ENV, cwd=str(ws)),
    }
    for who, p in procs.items():
        out, err = p.communicate(stdin, timeout=TIMEOUT)
        assert p.returncode == 0, (who, err[-3000:])
        assert "duplicate request id 's3' skipped (journal)" in err, (who, err[-2000:])
        runs[who] = _auto_ids_by_position(answers(out))
    port, ref = runs["port"], runs["jax"]
    assert [d["id"] for d in port] == [d["id"] for d in ref]
    assert [d["id"] for d in port] == ["req-0", "req-1"] + [f"s{i}" for i in range(8)]
    assert port == ref
    assert port[0]["outcome"] == "error" and port[0]["error"].startswith("bad JSON")
    assert all(d["outcome"] == "ok" and d["tokens"] for d in port[1:])

    def journal(name):
        recs = [json.loads(l) for l in open(ws / name) if l.strip()]
        for r in recs:
            r["id"] = re.sub(r"^req-\d+-(\d+)$", r"req-\1", r["id"])
        return recs

    assert journal("port.jsonl") == journal("jax.jsonl")

    # serve-status and serve-report read the port's run (both jax- and
    # torch-free readers, so in this process)
    from paddle_tpu_torch import cli

    status = json.load(open(ws / "status.json"))
    assert status["started"] is True and status["totals"]["ok"] == 9
    capsys.readouterr()
    assert cli.main(["serve-status", str(ws / "status.json")]) == 0
    assert "completed           9" in capsys.readouterr().out
    assert cli.main(["serve-report", str(ws / "run")]) == 0
    report = capsys.readouterr().out
    assert "ttft p99" in report and "pipelined decode: on" in report, report


def test_serve_oom_premortem_exit20(ws):
    """An injected serve.oom at the 2nd collect boundary: oom_report.json
    in the run dir and exit 20."""
    ws, cfg, ckpt = ws
    run_dir = ws / "oom_run"
    reqs = "\n".join(json.dumps({"id": f"o{i}", "prompt": [4 + i, 7], "max_new_tokens": 4})
                     for i in range(2))
    out = subprocess.run(
        port_cmd("serve", f"--config={cfg}", f"--init_model_path={ckpt}", *SERVE,
                 f"--metrics_path={run_dir}", "--fault_spec=serve.oom=raise@2"),
        input=reqs + "\n", capture_output=True, text=True, timeout=TIMEOUT, env=PORT_ENV)
    assert out.returncode == EXIT_OOM, (out.returncode, out.stderr[-3000:])
    report = json.load(open(run_dir / "oom_report.json"))
    assert "RESOURCE_EXHAUSTED" in report["error"], report["error"]
    assert report["reason"] == "oom" and report["device_kind"] == "cpu"
    assert report["live"]["host_rss_bytes"] > 0


def test_serve_stall_hangwatch_exit19_with_forensics(ws):
    """An injected serve.stall wedges the 2nd decode collect: the
    hangwatch writes serve_hang_report.json (thread stacks and the wedged
    cohort), flushes the cohort's error answers and exits 19."""
    ws, cfg, ckpt = ws
    run_dir = ws / "hang_run"
    status = ws / "hang_status.json"
    reqs = "\n".join(json.dumps({"id": f"h{i}", "prompt": [4 + i, 7], "max_new_tokens": 4})
                     for i in range(2))
    out = subprocess.run(
        port_cmd("serve", f"--config={cfg}", f"--init_model_path={ckpt}", *SERVE,
                 f"--metrics_path={run_dir}", f"--status_path={status}",
                 "--serve_hang_timeout=2", "--fault_spec=serve.stall=sleep:3600@2"),
        input=reqs + "\n", capture_output=True, text=True, timeout=TIMEOUT, env=PORT_ENV)
    assert out.returncode == EXIT_HANG, (out.returncode, out.stderr[-3000:])
    got = {d["id"]: d for d in answers(out.stdout)}
    assert set(got) == {"h0", "h1"}, (got, out.stderr[-2000:])
    assert all(d["outcome"] == "error" and "hang" in d.get("error", "")
               for d in got.values()), got
    report = json.load(open(run_dir / SERVE_HANG_REPORT))
    assert report["reason"] == "serve_hang" and report["threads"]
    slotted = [s["rid"] for s in report["inflight"]["slots"] if s]
    assert slotted and set(slotted) <= {"h0", "h1"}, report["inflight"]
    assert json.load(open(status))["started"] is True


def test_serve_stall_supervised_restart_answers_journal(ws, tmp_path):
    """`supervise --supervise_job=serve` under an injected serve.stall:
    the child's hangwatch exits 19, the supervisor restarts it, the
    journal re-offers every accepted-but-unanswered request, and the
    supervision ends rc 0 after exactly two attempts, every id answered
    and none twice within an attempt.

    8 requests x 2 slots x budget 2 = 8 collect boundaries in the first
    run; the stall at boundary 7 wedges the last cohort."""
    _, cfg, ckpt = ws
    save_dir, sup_dir = tmp_path / "out", tmp_path / "sup"
    jpath = tmp_path / "journal.jsonl"
    ids = [f"j{i}" for i in range(8)]
    reqs = "\n".join(json.dumps({"id": rid, "prompt": [4 + i, 7], "max_new_tokens": 2})
                     for i, rid in enumerate(ids))
    out = subprocess.run(
        port_cmd("supervise", "--supervise_job=serve", f"--config={cfg}",
                 f"--init_model_path={ckpt}", *SERVE, f"--save_dir={save_dir}",
                 f"--supervise_dir={sup_dir}", f"--serve_journal_path={jpath}",
                 f"--compile_cache_dir={tmp_path / 'ccache'}", "--serve_hang_timeout=3",
                 "--restart_base_delay=0.01", "--fault_spec=serve.stall=sleep:3600@7"),
        input=reqs + "\n", capture_output=True, text=True, timeout=TIMEOUT, env=PORT_ENV,
        cwd=str(tmp_path))
    assert out.returncode == 0, (out.returncode, out.stderr[-3000:])
    report = json.load(open(save_dir / SERVE_HANG_REPORT))
    assert report["reason"] == "serve_hang"
    logs = sorted(n for n in os.listdir(sup_dir) if n.startswith("attempt-"))
    assert logs == ["attempt-000.log", "attempt-001.log"], logs

    def results(log_name):
        got = {}
        for line in open(sup_dir / log_name):
            line = line.strip()
            if not line.startswith("{"):
                continue
            doc = json.loads(line)
            if "outcome" in doc and doc.get("id") in ids:
                assert doc["id"] not in got, f"{doc['id']} answered twice in {log_name}"
                got[doc["id"]] = doc["outcome"]
        return got

    first, second = results(logs[0]), results(logs[1])
    assert set(first) | set(second) == set(ids), (first, second)
    # the wedged cohort heard "the server hung" (the hangwatch's answers
    # just before exit 19) or was re-offered by the journal and answered
    # by the restarted server
    unanswered = set(ids) - set(first)
    assert unanswered <= set(second), (unanswered, second)
    assert all(second[rid] == "ok" for rid in unanswered), second
    assert all(o == "ok" for o in first.values() if o != "error"), first
    if unanswered:
        assert any("re-offering" in open(sup_dir / l).read() for l in logs) \
            or "re-offering" in out.stderr
    assert "names nothing to cache" in open(sup_dir / logs[0]).read() + out.stderr
    accepted = {json.loads(l)["id"] for l in open(jpath)
                if l.strip() and json.loads(l).get("op") == "accept"}
    assert accepted == set(ids)
    assert not os.path.exists(sup_dir / CRASH_REPORT)
