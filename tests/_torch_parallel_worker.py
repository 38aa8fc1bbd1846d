"""One rank of the port's parallel tests on the CPU (gloo).

Launched by tests/test_torch_parallel_ops.py and test_torch_parallel_train.py
as ``python tests/_torch_parallel_worker.py <job> <rank> <world> <port> <dir>``.
Imports torch and the port only. Reads <dir>/inputs.pt (written by the
test with the JAX package's inputs), runs the job's checks over meshes of
the world's ranks and writes what the test compares to <dir>/out_<rank>.pt.
Every mesh uses every rank, so the ranks build them in the same order.
"""

import os
import signal
import sys
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from f5e_tts_tpu_torch.config import (CFMConfig, DiTConfig, MelConfig, MeshConfig,  # noqa: E402
                                      ModelConfig, TrainConfig)
from f5e_tts_tpu_torch.models import cfm as tcfm  # noqa: E402
from f5e_tts_tpu_torch.models import dit as tdit  # noqa: E402
from f5e_tts_tpu_torch.ops.ring_attention import ring_attention  # noqa: E402
from f5e_tts_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from f5e_tts_tpu_torch.parallel import multihost  # noqa: E402
from f5e_tts_tpu_torch.parallel import pipeline as ppipe  # noqa: E402
from f5e_tts_tpu_torch.train import step as tstep  # noqa: E402
from f5e_tts_tpu_torch.train.trainer import (Trainer, loss_with_device_mel,  # noqa: E402
                                              make_sample_logger)


def mesh_of(**axes):
    return pmesh.make_mesh(MeshConfig(**{"data": 1, **axes}), "cpu")


# ---------------------------------------------------------------------------
# ops: ring attention, the DiT forward under TP / SP / TP x DP, GPipe
# ---------------------------------------------------------------------------


def ring_checks(inp, out):
    mesh = mesh_of(seq=4)
    q, k, v = (inp["ring"][n].clone().requires_grad_(True) for n in ("q", "k", "v"))
    for rope in (False, True):
        for t in (q, k, v):
            t.grad = None
        cos, sin = (inp["ring"]["cos"], inp["ring"]["sin"]) if rope else (None, None)
        o = ring_attention(q, k, v, inp["ring"]["kv_lens"], mesh, "seq", cos, sin)
        (o * inp["ring"]["w"]).sum().backward()
        out[f"ring_rope{int(rope)}"] = {"out": o.detach(), "dq": q.grad.clone(),
                                        "dk": k.grad.clone(), "dv": v.grad.clone()}
    # K/V stay sharded: a rank's ring only ever holds N/S rows of them
    seen = []
    shift = pmesh.Mesh.shift

    def spy(self, tensors, axis, step=1):
        seen.extend(tuple(t.shape) for t in tensors)
        return shift(self, tensors, axis, step)

    pmesh.Mesh.shift = spy
    try:
        ring_attention(q, k, v, None, mesh, "seq")
    finally:
        pmesh.Mesh.shift = shift
    out["ring_shift_shapes"] = seen


def dit_forward_checks(inp, out):
    d = inp["dit"]
    for name, axes, pe in (("tp4", {"model": 4}, None), ("dp2_tp2", {"data": 2, "model": 2}, None),
                           ("sp4", {"seq": 4}, None), ("tp2_sp2", {"model": 2, "seq": 2}, None),
                           ("tp4_partial", {"model": 4}, 1), ("dp2_tp2_partial",
                                                              {"data": 2, "model": 2}, 1)):
        mesh = mesh_of(**axes)
        cfg = DiTConfig(**{**d["cfg"], "pe_attn_head": pe})
        params = pmesh.shard_dit_params(d["params"], mesh, cfg)
        rows = (lambda t: pmesh.local_rows(t, mesh))
        f = torch.zeros(d["x"].shape[0], dtype=torch.bool)
        with torch.no_grad(), pmesh.active(mesh, min_seq=8):
            pred = tdit.dit_forward(params, cfg, x=rows(d["x"]), cond=rows(d["cond"]),
                                    text_ids=rows(d["text"]), time=rows(d["time"]),
                                    drop_audio_cond=rows(f), drop_text=rows(f),
                                    compute_dtype=torch.float32)
        out[f"dit_{name}"] = mesh.all_gather(pred, 0, pmesh.BATCH_AXES)
    # dropout under TP: the FF hidden's mask drawn at full width and sliced
    mesh = mesh_of(model=4)
    cfg = DiTConfig(**{**d["cfg"], "dropout": 0.3})
    f = torch.zeros(d["x"].shape[0], dtype=torch.bool)
    with torch.no_grad(), pmesh.active(mesh):
        out["dit_tp4_dropout"] = tdit.dit_forward(
            pmesh.shard_dit_params(d["params"], mesh, cfg), cfg, x=d["x"], cond=d["cond"],
            text_ids=d["text"], time=d["time"], drop_audio_cond=f, drop_text=f, training=True,
            generator=torch.Generator().manual_seed(5), compute_dtype=torch.float32)


def _gpipe_body(h, sl, t_emb, mask):
    y = torch.tanh(h @ sl["w"] + sl["b"] + t_emb[:, None, :])
    return torch.where(mask[:, :, None], y, h)


def gpipe_checks(inp, out):
    g = inp["gpipe"]
    for name, axes, n_micro in (("pipe4_m4", {"pipe": 4}, 4), ("pipe4_m8", {"pipe": 4}, 8),
                                ("dp2_pipe2_m2", {"data": 2, "pipe": 2}, 2)):
        mesh = mesh_of(**axes)
        items = [{"w": g["w"][i].clone().requires_grad_(True),
                  "b": g["b"][i].clone().requires_grad_(True)} for i in range(g["w"].shape[0])]
        h0 = pmesh.local_rows(g["h0"], mesh).clone().requires_grad_(True)
        t_emb = pmesh.local_rows(g["t_emb"], mesh).clone().requires_grad_(True)
        mask = pmesh.local_rows(g["mask"], mesh)
        stage = pmesh.stage_blocks(items, mesh)
        y = ppipe.gpipe_scan(_gpipe_body, h0, stage, mesh, n_micro=n_micro, batched=(t_emb, mask))
        (y.square().sum()).backward()
        # every stage's gradients for its blocks, in depth order, summed over the data shards
        dw, db = (mesh.all_reduce(mesh.all_gather(torch.stack([it[n].grad for it in stage]), 0,
                                                  "pipe"), pmesh.BATCH_AXES) for n in ("w", "b"))
        gather = (lambda t: mesh.all_gather(t, 0, pmesh.BATCH_AXES))
        out[f"gpipe_{name}"] = {"y": gather(y.detach()), "dh0": gather(h0.grad),
                                "dt_emb": gather(t_emb.grad), "dw": dw, "db": db}
    # dropout under the pipeline: microbatches draw their own masks
    d = inp["pp_dropout"]
    cfg = DiTConfig(**d["cfg"])
    mesh = mesh_of(pipe=4)
    params = pmesh.shard_dit_params(d["params"], mesh, cfg)
    f = torch.zeros(d["x"].shape[0], dtype=torch.bool)

    def fwd(seed):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad(), pmesh.active(mesh, n_micro=4):
            return tdit.dit_forward(params, cfg, x=d["x"], cond=d["cond"], text_ids=d["text"],
                                    time=d["time"], drop_audio_cond=f, drop_text=f,
                                    training=True, generator=gen, compute_dtype=torch.float32)

    out["pp_dropout"] = {"a": fwd(5), "b": fwd(5), "other_seed": fwd(6)}
    # refused: TP inside a stage, an active SP context
    refusals = {}
    for what, other in (("tp", mesh_of(model=4)), ("sp", mesh_of(seq=4))):
        try:
            with pmesh.active(other, min_seq=2):
                ppipe.gpipe_scan(_gpipe_body, g["h0"][:4], [], mesh,
                                 batched=(g["t_emb"][:4], g["mask"][:4]))
            refusals[what] = ""
        except ValueError as e:
            refusals[what] = str(e)
    out["pp_refusals"] = refusals


def misc_checks(inp, out):
    mesh = mesh_of(data=2, model=2)
    out["coords"] = (mesh.coords, mesh.index(pmesh.BATCH_AXES), mesh.peer("model", 1))
    batch = {"mel_lens": torch.arange(3, dtype=torch.int32) + 5, "mel": torch.ones(3, 4, 2)}
    out["shard_batch"] = pmesh.shard_batch(batch, mesh)
    full = inp["dit"]["params"]
    cfg = DiTConfig(**inp["dit"]["cfg"])
    for name, axes in (("fsdp_tp", {"fsdp": 2, "model": 2}), ("pipe", {"data": 2, "pipe": 2})):
        m = mesh_of(**axes)
        back = pmesh.gather_dit_params(pmesh.shard_dit_params(full, m, cfg), m, cfg)
        out[f"roundtrip_{name}"] = all(torch.equal(a, b) for a, b in zip(
            tstep.tree_leaves(back), tstep.tree_leaves(full)))
    out["split"] = [multihost.split_between_processes(list(range(7)), pad=p) for p in (False, True)]
    out["broadcast"] = multihost.broadcast_from_host0(
        torch.full((2,), float(multihost.process_index())).numpy()).tolist()


# ---------------------------------------------------------------------------
# train: Trainer steps under each mesh, preemption and resume, 8-bit AdamW
# ---------------------------------------------------------------------------


def tiny_model(inp):
    t = inp["train"]
    return ModelConfig(name="tiny", backbone="DiT", arch=DiTConfig(**t["arch"]),
                       mel=MelConfig(**t["mel"]), cfm=CFMConfig())


def make_trainer(inp, mesh_cfg, save_dir, bnb=False, tc_extra=None, **kw):
    t = inp["train"]
    tc = TrainConfig(**{**t["tc"], "mesh": mesh_cfg, "save_dir": save_dir,
                        "bnb_optimizer": bnb, **(tc_extra or {})})
    return Trainer(tiny_model(inp), tc, vocab_size=t["vocab"], tokenize=None, device="cpu",
                   **kw)


def trainer_steps(inp, out, name, mesh_cfg, root):
    """Two updates from the reference params on the batches and draws of the
    JAX steps (a seq axis's ring engaged from 8 frames); the full params, EMA
    and moments after them, and a saved model_last."""
    t = inp["train"]
    tr = make_trainer(inp, mesh_cfg, os.path.join(root, name), ring_min_seq=8)
    ts = tr.init_state(t["total"], pretrained_path=t["pretrained"])
    step = tr.make_step()
    metrics = []
    for i, draws in enumerate(t["draws"]):
        batch = pmesh.shard_batch(t["batch"], tr.mesh)
        ts, m = step(ts, tr.device_batch(batch), tr.step_generator(ts),
                     draws=tcfm.LossDraws(**draws))
        metrics.append((m.loss, m.grad_norm, m.skipped))
    full = tr.full_state(ts)
    full = tstep.TrainState(**{**vars(full), **{k: tstep.tree_map(lambda x: x.detach(), getattr(
        full, k)) for k in ("params", "ema_params")}})
    w = ts.params["blocks"][0]["attn"]["to_q"]["w"]
    at = [id(x) for x in tstep.tree_leaves(ts.params)].index(id(w))
    local = {"q_shape": tuple(w.shape), "mu_shape": tuple(ts.opt_state.mu[at].shape),
             "ema_shape": tuple(ts.ema_params["blocks"][0]["attn"]["to_q"]["w"].shape),
             "blocks": len(ts.params["blocks"])}
    with torch.no_grad(), tr.mesh_context():  # the global batch's loss at fixed draws
        eval_loss = loss_with_device_mel(
            ts.params, tr.arch, tr.cfm, tr.model_cfg.mel,
            tr.device_batch(pmesh.shard_batch(t["batch"], tr.mesh)),
            draws=tcfm.LossDraws(**t["eval_draws"]), compute_dtype=torch.float32).loss
    tr.save_checkpoint(ts, last=True)
    out[f"train_{name}"] = {"metrics": metrics, "params": full.params, "ema": full.ema_params,
                            "mu": full.opt_state.mu, "local": local,
                            "eval_loss": float(eval_loss),
                            "schedule1": tr.optimizer.schedule(1),
                            "transport": tr.mesh.transport}


class _Sampler:
    def set_epoch(self, epoch):
        pass


class Loader:
    """Seeded global batches, each rank taking its rows (ShardedLoader)."""

    def __init__(self, batches):
        self.batches, self.sampler = batches, _Sampler()

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def preempt_resume(inp, out, root):
    """The JAX test_multihost_trainer phases over (data=2, fsdp=2): A 6
    updates; B SIGTERM on every rank at update 3 (model_last saved, every
    rank stops); C resumes from B and must repeat A's losses 4-6 bit for bit."""
    mesh_cfg = MeshConfig(data=2, fsdp=2)
    batches = inp["train"]["loader"]

    def run(sub, log_fn, resume):
        tr = make_trainer(inp, mesh_cfg, os.path.join(root, sub), log_fn=log_fn)
        loader = pmesh.ShardedLoader(Loader(batches), tr.mesh)
        return tr.train(loader, epochs=2, resume=resume, max_updates=6)

    la = {}
    ts_a, _ = run("a", lambda m, u: la.__setitem__(u, m["loss"]), False)
    fired = {}

    def sigterm_at_3(m, u):
        if u == 3 and not fired:
            fired["x"] = True
            os.kill(os.getpid(), signal.SIGTERM)

    ts_b, info_b = run("b", sigterm_at_3, False)
    lc = {}
    ts_c, _ = run("b", lambda m, u: lc.__setitem__(u, m["loss"]), True)
    out["preempt"] = {"a": la, "c": lc, "b_update": ts_b.update,
                      "b_preempted": info_b["preempted"],
                      "b_last": os.path.exists(os.path.join(root, "b", "model_last.pt")),
                      "c_update": ts_c.update}


def bnb_checks(inp, out, root):
    t = inp["train"]
    refused = ""
    try:
        make_trainer(inp, MeshConfig(data=2, fsdp=2), os.path.join(root, "bnb_f"), bnb=True)
    except NotImplementedError as e:
        refused = str(e)
    tr = make_trainer(inp, MeshConfig(data=2, pipe=2), os.path.join(root, "bnb_p"), bnb=True)
    ts = tr.init_state(t["total"], pretrained_path=t["pretrained"])
    step = tr.make_step()
    for draws in t["draws"]:
        ts, m = step(ts, tr.device_batch(pmesh.shard_batch(t["batch"], tr.mesh)),
                     tr.step_generator(ts), draws=tcfm.LossDraws(**draws))
    full = tr.full_state(ts)
    tr.save_checkpoint(ts, last=True)
    back = tr.full_state(tr.load_checkpoint(tr.init_state(t["total"])))
    same = all(torch.equal(a, b) for a, b in zip(
        tstep.tree_leaves([full.params, full.opt_state.mu, full.opt_state.nu]),
        tstep.tree_leaves([back.params, back.opt_state.mu, back.opt_state.nu])))
    out["bnb"] = {"refused": refused, "roundtrip": same, "loss": m.loss}


def sample_checks(inp, out, root):
    """The sample hook (make_sample_logger) under the meshes that shard the
    DiT (data 2 x model 2, data 2 x fsdp 2, data 2 x pipe 2): two updates from
    the reference params, the hook at update 2 on rank 0, then model_last.
    The test runs the hook on that checkpoint's EMA in its own process."""
    s = inp["sample"]
    for name in ("dp2_tp2", "fsdp2", "dp2_pp2"):
        save = os.path.join(root, f"sample_{name}")
        hook = make_sample_logger(tiny_model(inp), s["vocab"], "char", save, s["text"],
                                  s["ref_mel"], s["ref_text"], nfe=s["nfe"], device="cpu")
        axes = inp["train"]["meshes"][name]
        tr = make_trainer(inp, MeshConfig(**{"data": 1, **axes}), save, sample_fn=hook,
                          tc_extra={"log_samples_per_updates": 2})
        tr.init_state(inp["train"]["total"], pretrained_path=inp["train"]["pretrained"])
        loader = pmesh.ShardedLoader(Loader(inp["train"]["loader"][:2]), tr.mesh)
        ts, _ = tr.train(loader, epochs=1, resume=False, max_updates=2)
        out[f"sample_{name}"] = {"update": ts.update, "dir": save}


def cli_run(inp, out):
    """The YAML CLI (train/train.py) in every rank of the world: its `mesh:`
    section (data 2 x fsdp 2), two updates, model_last from rank 0."""
    from f5e_tts_tpu_torch.train import train as tcli

    c = inp["cli"]
    ts = tcli.main(["--config", c["yaml"], "--data_dir", c["data_dir"], "--device", "cpu",
                    "--max_updates", "2", "--no_resume"])
    out["cli"] = {"update": ts.update, "local_q": tuple(
        ts.params["blocks"][0]["attn"]["to_q"]["w"].shape)}


def main():
    job, rank, world, port, root = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                    int(sys.argv[4]), sys.argv[5])
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank)
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = {}
    try:
        if job == "ops":
            ring_checks(inp, out)
            dit_forward_checks(inp, out)
            gpipe_checks(inp, out)
            misc_checks(inp, out)
        else:
            ckpts = os.path.join(root, "ckpts")
            for name, axes in inp["train"]["meshes"].items():
                trainer_steps(inp, out, name, MeshConfig(**{"data": 1, **axes}), ckpts)
            sample_checks(inp, out, ckpts)
            bnb_checks(inp, out, ckpts)
            preempt_resume(inp, out, ckpts)
            cli_run(inp, out)
    except Exception:
        # the peers' collectives fail once this rank is gone, so every rank reports
        torch.save({"error": traceback.format_exc()}, os.path.join(root, f"out_{rank}.pt"))
        os._exit(1)
    torch.save(out, os.path.join(root, f"out_{rank}.pt"))
    multihost.shutdown()



# ---------------------------------------------------------------------------
# the test's side: start the world, collect what the ranks wrote
# ---------------------------------------------------------------------------


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(job: str, world: int, root: str) -> list:
    """Start `world` ranks of `job` on the CPU (one thread each) over <root>/inputs.pt."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}
    port = _free_port()
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r), str(world),
                              str(port), root], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def collect(procs: list, root: str, timeout: float = 300.0) -> list:
    """Every rank's outputs once all have exited; raises with a rank's
    traceback (or its log) when one failed."""
    import subprocess

    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError("parallel workers timed out:\n" + "\n---\n".join(logs))
    outs = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        path = os.path.join(root, f"out_{rank}.pt")
        out = torch.load(path, weights_only=False) if os.path.exists(path) else {}
        if p.returncode != 0 or "error" in out:
            raise RuntimeError(f"rank {rank} rc={p.returncode}\n{out.get('error', '')}\n{log[-3000:]}")
        outs.append(out)
    return outs


if __name__ == "__main__":
    main()
