"""Worker of ``tests/test_torch_elastic.py``: trains a small model of the
weights in ``ELASTIC_WEIGHTS`` with ``AutoCheckpointer`` on the port
(imports torch, numpy and the port only), each step's loss written to
``ELASTIC_LOG.<rank>`` as "attempt rank step loss".

``ELASTIC_TEST_MODE``: ``crash`` — rank 1 exits 1 at step
``ELASTIC_CRASH_STEP`` on attempt 0, once rank 0 has logged that step; ``preempt`` — rank 0 sends itself
SIGTERM there on attempt 0 (the autocheckpoint saves and exits 101)."""
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

RANK = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
ATTEMPT = int(os.environ.get("PADDLE_RESTART_ATTEMPT", "0"))
MODE = os.environ.get("ELASTIC_TEST_MODE", "")
CRASH_STEP = int(os.environ.get("ELASTIC_CRASH_STEP", "5"))
TOTAL = int(os.environ.get("ELASTIC_TOTAL_STEPS", "10"))
CKPT = os.environ["ELASTIC_CKPT_DIR"]
LOG = os.environ["ELASTIC_LOG"]


def log(step, loss):
    with open(f"{LOG}.{RANK}", "a") as f:
        f.write(f"{ATTEMPT} {RANK} {step} {loss:.8f}\n")


def _wait_for_rank0(step, timeout=60.0):
    """Until rank 0 has logged ``step`` (the crash lands with both ranks
    past it, whichever started first)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(f"{LOG}.0") as f:
                if any(int(line.split()[2]) >= step for line in f):
                    return
        except OSError:
            pass
        time.sleep(0.05)


def main():
    import torch

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.fleet.elastic import AutoCheckpointer

    paddle.set_device("cpu")
    torch.set_num_threads(1)
    w = np.load(os.environ["ELASTIC_WEIGHTS"])
    model = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 1))
    model.set_state_dict({k: w[k] for k in w.files})
    opt = optimizer.Adam(parameters=model.parameters(), learning_rate=0.05)
    ckpt = AutoCheckpointer(model, opt, path=CKPT, save_every=1, rank=RANK)
    start = ckpt.resume()
    rs = np.random.RandomState(42)
    data = [(rs.randn(8, 4).astype("float32"),
             rs.randn(8, 1).astype("float32")) for _ in range(TOTAL)]
    step_delay = float(os.environ.get("ELASTIC_STEP_DELAY", "0"))
    for step in range(start, TOTAL):
        if step_delay:
            time.sleep(step_delay)      # ranks are mid-run when the pod dies
        x, y = (paddle.to_tensor(a) for a in data[step])
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        log(step, float(loss.numpy()))
        if ATTEMPT == 0 and step == CRASH_STEP:
            if MODE == "crash" and RANK == 1:
                _wait_for_rank0(step)
                os._exit(1)
            if MODE == "preempt" and RANK == 0:
                os.kill(os.getpid(), signal.SIGTERM)
        ckpt.step(step)
    print(f"rank {RANK} done at step {TOTAL - 1}")


if __name__ == "__main__":
    main()
