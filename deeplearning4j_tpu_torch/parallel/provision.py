"""Cluster provisioning — the GPU analog of the reference's AWS module
(``deeplearning4j-aws``): ``Ec2BoxCreator.java:19,59`` (create spot/
on-demand instances), ``provision/ClusterSetup.java:24`` +
``HostProvisioner`` (SSH fan-out setup), and the YARN ``Client`` launch
path.

Port of ``deeplearning4j_tpu/parallel/provision.py``, aimed at H100 hosts
instead of a TPU pod slice.  The module renders, as data (and optionally
as one shell script), the commands that create the hosts, bootstrap each
one and start the training job on every card; ``apply(dry_run=True)``, the
default, runs nothing.  What differs from the reference, and why:

- **Hosts.**  ``accelerator_type`` is ``h100-<N>``: N H100 cards, eight to
  a host (Google Cloud's ``a3-highgpu-8g``; a cluster of fewer than eight
  is one ``a3-highgpu-<N>g``).  The hosts are Compute Engine instances
  named ``<name>-0`` … ``<name>-<hosts-1>`` (``gcloud compute instances``),
  not a TPU VM (``gcloud compute tpus tpu-vm``), on the Deep Learning VM
  image (``runtime_version`` is its image family, with the CUDA toolkit
  the kernels' ``nvcc`` build needs).
- **Fan-out.**  ``gcloud compute ssh`` reaches one instance, where the
  reference's ``tpu-vm ssh --worker=all`` reaches them all: the port's
  ``ssh_all_command`` is a ``bash`` loop that runs one ``ssh`` per host in
  parallel and fails if any of them fails.  The remote command is its last
  argument, as ``--command=…`` is the reference's.
- **Launch contract.**  Each card is one rank (one process, its card as
  ``cuda:0`` through ``CUDA_VISIBLE_DEVICES``), and the environment is the
  one ``parallel.mesh.initialize_multihost`` reads: ``MASTER_ADDR``,
  ``MASTER_PORT`` (``coordinator_port``, torch's customary 29500),
  ``WORLD_SIZE`` (every card) and ``RANK``, in place of
  ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
  (one process a host).  A host derives its index from its name's suffix,
  as a TPU host reads its worker number from the metadata server.
- **Bootstrap** installs the port's dependencies (``torch``, ``numpy``),
  not ``jax[tpu]``; the launched program is ``python -m
  deeplearning4j_tpu_torch …``.
"""

from __future__ import annotations

import dataclasses
import shlex
import subprocess
from pathlib import Path

__all__ = ["PodSliceSpec", "PodSliceProvisioner"]

#: cards a host holds (a3-highgpu-8g); smaller clusters are one host
_CHIPS_PER_HOST = 8
_GENERATIONS = {"h100": "a3-highgpu"}
_IMAGE_PROJECT = "deeplearning-platform-release"


@dataclasses.dataclass(frozen=True)
class PodSliceSpec:
    """What ``Ec2BoxCreator``'s (ami, size, numBoxes) tuple becomes here:
    a named cluster of H100 cards in a zone."""

    name: str = "dl4j-h100"
    accelerator_type: str = "h100-64"
    zone: str = "us-central1-a"
    runtime_version: str = "common-cu124"
    project: str | None = None
    spot: bool = False                        # Ec2BoxCreator spot parity
    coordinator_port: int = 29500

    @property
    def generation(self) -> str:
        gen = self.accelerator_type.rsplit("-", 1)[0]
        if gen not in _GENERATIONS:
            raise ValueError(
                f"accelerator_type {self.accelerator_type!r}: expected "
                f"{'|'.join(_GENERATIONS)}-<cards>")
        return gen

    @property
    def n_chips(self) -> int:
        self.generation                      # validates the type
        return max(1, int(self.accelerator_type.rsplit("-", 1)[1]))

    @property
    def n_hosts(self) -> int:
        return -(-self.n_chips // _CHIPS_PER_HOST)

    @property
    def chips_per_host(self) -> int:
        return min(self.n_chips, _CHIPS_PER_HOST)

    @property
    def machine_type(self) -> str:
        return f"{_GENERATIONS[self.generation]}-{self.chips_per_host}g"

    @property
    def host_names(self) -> list[str]:
        return [f"{self.name}-{i}" for i in range(self.n_hosts)]


class PodSliceProvisioner:
    """Renders the create/bootstrap/launch command set for a cluster."""

    def __init__(self, spec: PodSliceSpec):
        self.spec = spec

    # -- creation (Ec2BoxCreator.create parity) -------------------------
    def create_command(self) -> list[str]:
        s = self.spec
        cmd = ["gcloud", "compute", "instances", "create", *s.host_names,
               f"--zone={s.zone}",
               f"--machine-type={s.machine_type}",
               f"--image-family={s.runtime_version}",
               f"--image-project={_IMAGE_PROJECT}",
               "--maintenance-policy=TERMINATE"]
        if s.project:
            cmd.append(f"--project={s.project}")
        if s.spot:
            cmd.append("--provisioning-model=SPOT")
        return cmd

    def delete_command(self) -> list[str]:
        s = self.spec
        return ["gcloud", "compute", "instances", "delete", *s.host_names,
                f"--zone={s.zone}", "--quiet"]

    # -- per-host bootstrap (HostProvisioner parity) --------------------
    def bootstrap_command(self, repo_url: str,
                          workdir: str = "~/deeplearning4j_tpu") -> str:
        """What ``HostProvisioner`` uploads+runs over SSH: fetch the
        framework and its deps onto every host."""
        return (f"git clone {shlex.quote(repo_url)} {workdir} 2>/dev/null "
                f"|| git -C {workdir} pull && "
                f"pip install -U torch numpy")

    def ssh_all_command(self, remote_cmd: str) -> list[str]:
        """Run ``remote_cmd`` on every host at once (one ``gcloud compute
        ssh`` each); fails if any host's command fails."""
        s = self.spec
        ssh = (f'gcloud compute ssh "$h" --zone={shlex.quote(s.zone)} '
               '--command="$1"')
        loop = (f"pids=; for h in {' '.join(s.host_names)}; do {ssh} & "
                'pids="$pids $!"; done; rc=0; '
                "for p in $pids; do wait $p || rc=1; done; exit $rc")
        return ["bash", "-c", loop, "ssh_all", remote_cmd]

    # -- coordinated launch (ClusterSetup + initialize_multihost) -------
    def launch_env(self, process_id: int, coordinator_host: str) -> dict[str, str]:
        """One rank's env for ``initialize_multihost`` (the Akka-seed-join
        replacement): the rendezvous on host 0, one rank a card."""
        s = self.spec
        return {
            "MASTER_ADDR": coordinator_host,
            "MASTER_PORT": str(s.coordinator_port),
            "WORLD_SIZE": str(s.n_chips),
            "RANK": str(process_id),
        }

    def launch_command(self, train_argv: str, coordinator_host: str,
                       workdir: str = "~/deeplearning4j_tpu") -> str:
        """One command runnable on every host: each host derives its index
        from its name's suffix and starts the same program once a card
        (SPMD, one rank a card, the card as ``cuda:0``)."""
        s = self.spec
        g = s.chips_per_host
        env = " ".join(
            f"{k}={v}" for k, v in self.launch_env(0, coordinator_host).items()
            if k != "RANK")
        return (f"cd {workdir} && H=$(hostname | sed 's/.*-//') && "
                f"for L in $(seq 0 {g - 1}); do {env} "
                f"RANK=$((H * {g} + L)) CUDA_VISIBLE_DEVICES=$L "
                f"python {train_argv} & done; wait")

    # -- execution (ClusterSetup.java:24 actually provisions) ------------

    def describe_ip_command(self) -> list[str]:
        s = self.spec
        return ["gcloud", "compute", "instances", "describe", s.host_names[0],
                f"--zone={s.zone}",
                "--format=value(networkInterfaces[0].networkIP)"]

    def apply(self, repo_url: str, train_argv: str, *, dry_run: bool = True,
              coordinator_host: str | None = None,
              timeout_s: float = 1800.0) -> list[dict]:
        """EXECUTE the provisioning sequence — create the hosts, bootstrap
        every host, resolve the coordinator IP, launch everywhere — the way
        the reference's ``ClusterSetup``/``HostProvisioner`` actually SSH
        into boxes rather than printing commands.  ``dry_run`` (the
        default) returns the resolved command list without running
        anything; pass ``dry_run=False`` where a cloud and ``gcloud``
        exist.  Returns one ``{"step", "cmd", "rc", "stdout"}`` record per
        command (``rc`` is None under dry-run); raises on the first
        failing step, since later steps depend on earlier ones.  A step
        that exceeds ``timeout_s`` raises a ``RuntimeError`` naming the
        step with the records-so-far attached as ``err.records`` (a
        half-created cluster keeps its audit trail)."""
        records = []

        def run(step: str, cmd: list[str]) -> str:
            rec = {"step": step, "cmd": cmd, "rc": None, "stdout": ""}
            records.append(rec)
            if dry_run:
                return ""
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=timeout_s)
            except subprocess.TimeoutExpired as e:
                # a timed-out create/bootstrap leaves a HALF-CREATED cluster
                # behind: name the step and carry the audit trail so the
                # caller can tear down exactly what was attempted
                err = RuntimeError(
                    f"provision step {step!r} timed out after "
                    f"{timeout_s:.0f}s — the hosts may be half-created; "
                    "inspect err.records and run teardown()")
                err.records = records
                raise err from e
            rec["rc"] = proc.returncode
            rec["stdout"] = proc.stdout.strip()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"provision step {step!r} failed rc={proc.returncode}: "
                    f"{proc.stderr[-500:]}")
            return rec["stdout"]

        run("create", self.create_command())
        run("bootstrap", self.ssh_all_command(self.bootstrap_command(repo_url)))
        coord = coordinator_host or run("resolve_coordinator",
                                        self.describe_ip_command())
        if not coord:
            if dry_run:
                coord = "$COORD"     # placeholder, as in the rendered script
            else:
                # launching against an empty rendezvous address hangs every
                # rank in init_process_group with no error — fail here
                raise RuntimeError(
                    "coordinator IP resolve returned empty (instance "
                    "network not yet populated?) — refusing to launch")
        run("launch", self.ssh_all_command(
            self.launch_command(train_argv, coord)))
        return records

    def teardown(self, *, dry_run: bool = True,
                 timeout_s: float = 1800.0) -> dict:
        """EXECUTE host deletion (the Kill-side symmetry of ``apply``)."""
        cmd = self.delete_command()
        rec = {"step": "delete", "cmd": cmd, "rc": None, "stdout": ""}
        if not dry_run:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=timeout_s)
            except subprocess.TimeoutExpired as e:
                err = RuntimeError(
                    f"teardown step 'delete' timed out after {timeout_s:.0f}s "
                    "— the hosts may still exist; inspect err.records")
                err.records = [rec]
                raise err from e
            rec["rc"] = proc.returncode
            rec["stdout"] = proc.stdout.strip()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"teardown failed rc={proc.returncode}: "
                    f"{proc.stderr[-500:]}")
        return rec

    # -- one-file artifact ----------------------------------------------
    def render_script(self, repo_url: str, train_argv: str,
                      coordinator_host: str = "$(gcloud compute instances "
                      "describe {host0} --zone={zone} --format="
                      "'value(networkInterfaces[0].networkIP)')") -> str:
        s = self.spec
        coord = coordinator_host.format(host0=s.host_names[0], zone=s.zone)
        lines = [
            "#!/usr/bin/env bash",
            "# Auto-generated cluster provisioning script "
            f"({s.accelerator_type}, {s.n_hosts} hosts of {s.machine_type}, "
            f"{s.n_chips} cards)",
            "set -euo pipefail",
            "",
            "# 1. create the hosts",
            shlex.join(self.create_command()),
            "",
            "# 2. bootstrap every host",
            shlex.join(self.ssh_all_command(self.bootstrap_command(repo_url))),
            "",
            "# 3. resolve coordinator (host 0) and launch everywhere",
            f'COORD={coord}',
            # manual quoting: $COORD must expand in the OUTER shell, so the
            # remote command is double-quoted, not shlex-single-quoted;
            # every other $ (the host index, the rank arithmetic, the card
            # loop) is escaped so it runs on each host instead
            (shlex.join(self.ssh_all_command("")[:-1])
             + ' "' + self.launch_command(train_argv, "$COORD")
             .replace('"', '\\"').replace("$", "\\$")
             .replace("\\$COORD", "$COORD") + '"'),
            "",
        ]
        return "\n".join(lines)

    def write_script(self, path: str | Path, repo_url: str,
                     train_argv: str) -> Path:
        path = Path(path)
        path.write_text(self.render_script(repo_url, train_argv))
        path.chmod(0o755)
        return path
