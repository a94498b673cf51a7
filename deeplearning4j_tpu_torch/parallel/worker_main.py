"""Worker-process entry point: ``python -m
deeplearning4j_tpu_torch.parallel.worker_main <state_dir> <worker_id>
<performer_spec> [heartbeat_s] [poll_s]``.

Port of ``deeplearning4j_tpu/parallel/worker_main.py``: the process analog
of the reference's ``WorkerActor`` mainline — spawned by
:class:`~.procrunner.ProcessDistributedRunner`.
"""

import sys

from .procrunner import worker_loop

if __name__ == "__main__":
    state_dir, worker_id, performer_spec = sys.argv[1:4]
    heartbeat_s = float(sys.argv[4]) if len(sys.argv) > 4 else 0.05
    poll_s = float(sys.argv[5]) if len(sys.argv) > 5 else 0.02
    worker_loop(state_dir, worker_id, performer_spec, heartbeat_s, poll_s)
