"""batch_run: sharded batch execution with failed-batch retry.

The operational layer of the reference: SLURM/Condor job arrays with
per-batch failure files and retries (`aku/scripts/ClusterManager.pm:42-
205` failed_batch_retry_count, `pyrectool/submit-to-{slurm,condor}.sh`,
train.pl:345-396).  On one host the "array" is local worker processes
over the same ``-B/-I`` recipe shards; failures append to
``failed_batches.lst`` and failed shards retry up to ``--retries`` times
— the same protocol, minus the cluster scheduler.  Local workers that
use the GPU each get a card of their own through
``CUDA_VISIBLE_DEVICES`` (a JAX process reserves most of a card's
memory, so a second one on the same card fails), and ``-j`` may not
exceed the number of cards.

Usage: batch_run -B 8 [--retries 2] -- python -m aaltoasr_tpu.cli.stats
       -c cfg -r recipe -o out_{I} -B {B} -I {I}
``{B}``/``{I}`` in the command expand to the shard parameters.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def visible_cards() -> list:
    """The GPUs local workers may use: ``CUDA_VISIBLE_DEVICES`` when
    set, else what ``nvidia-smi -L`` lists, else none."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is not None:
        return [c.strip() for c in env.split(",") if c.strip()]
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [str(i) for i, line in enumerate(
        ln for ln in out.splitlines() if ln.startswith("GPU "))]


def worker_cards(jobs: int) -> list:
    """Cards to hand out to ``jobs`` concurrent local workers: empty
    when the workers run on the CPU (``JAX_PLATFORMS=cpu``) or no card
    is visible; refuses more workers than cards."""
    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        return []
    cards = visible_cards()
    if cards and jobs > len(cards):
        raise SystemExit(f"batch_run: -j {jobs} exceeds the {len(cards)} "
                         "visible GPU(s); one worker per card")
    return cards


def worker_env(card: str | None) -> dict:
    env = dict(os.environ)
    if card is not None:
        env["CUDA_VISIBLE_DEVICES"] = card
    return env


def run_shard(cmd_template, B, I) -> int:
    cmd = [c.replace("{B}", str(B)).replace("{I}", str(I))
           for c in cmd_template]
    return subprocess.run(cmd).returncode


def slurm_script(cmd, batches, failed_list, log_dir="logs",
                 sbatch_extra=""):
    """sbatch array script implementing the ClusterManager protocol:
    one array task per batch, failures appended to the failed list
    (`ClusterManager.pm:42-115` submit_batches + grant files;
    `pyrectool/submit-to-slurm.sh` array submission)."""
    run = " ".join(
        c.replace("{B}", str(batches))
        .replace("{I}", "${SLURM_ARRAY_TASK_ID}") for c in cmd)
    extra = f"#SBATCH {sbatch_extra}\n" if sbatch_extra else ""
    return (
        "#!/bin/bash\n"
        f"#SBATCH --no-requeue\n"
        f"#SBATCH --array=1-{batches}\n"
        f"#SBATCH -o {log_dir}/batch.stdout.%a\n"
        f"#SBATCH -e {log_dir}/batch.stderr.%a\n"
        f"{extra}"
        f"{run}\n"
        "rc=$?\n"
        f"if [ $rc -ne 0 ]; then echo ${{SLURM_ARRAY_TASK_ID}} >> "
        f"{failed_list}; fi\n"
        "exit $rc\n")


def submit_slurm(args, cmd) -> int:
    """Submit the batch array via sbatch --wait, rerunning failed
    batches up to --retries times (the ClusterManager retry loop)."""
    os.makedirs(args.log_dir, exist_ok=True)
    script = slurm_script(cmd, args.batches, args.failed_list,
                          args.log_dir, args.sbatch_args)
    script_path = os.path.join(args.log_dir, "batch_array.sh")
    with open(script_path, "w") as f:
        f.write(script)
    if args.dry_run:
        print(script)
        print(f"sbatch --wait {script_path}")
        return 0
    array = f"1-{args.batches}"
    for attempt in range(args.retries + 1):
        if os.path.exists(args.failed_list):
            os.remove(args.failed_list)
        rc = subprocess.run(
            ["sbatch", "--wait", f"--array={array}", script_path]
        ).returncode
        if rc == 0 and not os.path.exists(args.failed_list):
            return 0
        if not os.path.exists(args.failed_list):
            print(f"sbatch failed (rc {rc})", file=sys.stderr)
            return rc or 1
        failed = sorted({int(x) for x in
                         open(args.failed_list).read().split()})
        if attempt < args.retries:
            print(f"retrying {len(failed)} failed batch(es): {failed}",
                  file=sys.stderr)
            array = ",".join(str(i) for i in failed)
    print(f"batches failed after retries: {failed}", file=sys.stderr)
    return 1


EXEC_LINE = """#!/bin/sh
# Executes the command at the given (0-based) line of a file — the
# reference's per-process dispatch wrapper (pyrectool/exec-line.sh).
file="$1"
line=$(expr $2 + 1)
eval $(sed -n ${line}p "${file}")
"""


def condor_files(cmd, batch_ids, batches, failed_list, log_dir):
    """Condor job description + per-process command script implementing
    the submit-to-condor.sh protocol (`pyrectool/submit-to-condor.sh:
    30-60`): exec-line.sh wrapper dispatched by $(Process), a shared
    condor log with per-process out/err files, `queue N`.  The command
    lines carry the ClusterManager failure protocol (append the batch
    id to the failed list on nonzero exit)."""
    lines = []
    for i in batch_ids:
        run = " ".join(c.replace("{B}", str(batches))
                       .replace("{I}", str(i)) for c in cmd)
        lines.append(f"{run} || echo {i} >> {failed_list}")
    logfile = os.path.join(log_dir, "condor.log")
    wrapper = os.path.join(log_dir, "exec_line.sh")
    script = os.path.join(log_dir, "condor_cmds.sh")
    desc = (
        f"executable = {wrapper}\n"
        f"arguments = {script} $(Process)\n"
        f"log = {logfile}\n"
        f"output = {logfile}.out.$(Process)\n"
        f"error = {logfile}.err.$(Process)\n"
        f"queue {len(batch_ids)}\n")
    return desc, "\n".join(lines) + "\n", wrapper, script, logfile


def submit_condor(args, cmd) -> int:
    """Submit via condor_submit and block on condor_wait, rerunning
    failed batches up to --retries times; SIGINT removes the queued
    jobs (`submit-to-condor.sh:3-8` interrupt_handler condor_rm)."""
    os.makedirs(args.log_dir, exist_ok=True)
    batch_ids = list(range(1, args.batches + 1))
    for attempt in range(args.retries + 1):
        desc, cmds, wrapper, script, logfile = condor_files(
            cmd, batch_ids, args.batches, args.failed_list,
            args.log_dir)
        with open(wrapper, "w") as f:
            f.write(EXEC_LINE)
        os.chmod(wrapper, 0o755)
        with open(script, "w") as f:
            f.write(cmds)
        desc_path = os.path.join(args.log_dir, "condor_job.desc")
        with open(desc_path, "w") as f:
            f.write(desc)
        if args.dry_run:
            print(desc)
            print(f"condor_submit {desc_path} && condor_wait {logfile}")
            return 0
        if os.path.exists(args.failed_list):
            os.remove(args.failed_list)
        # fresh shared log per round: condor_wait reads it to completion
        if os.path.exists(logfile):
            os.remove(logfile)
        open(logfile, "w").close()
        try:
            rc = subprocess.run(["condor_submit", desc_path]).returncode
            if rc != 0:
                print(f"condor_submit failed (rc {rc})", file=sys.stderr)
                return rc
            rc = subprocess.run(["condor_wait", logfile]).returncode
            if rc != 0:
                print(f"condor_wait failed (rc {rc})", file=sys.stderr)
                return rc
        except KeyboardInterrupt:
            subprocess.run(["condor_rm", "-all"])
            os.remove(desc_path)
            return 3
        if not os.path.exists(args.failed_list):
            return 0
        failed = sorted({int(x) for x in
                         open(args.failed_list).read().split()})
        if attempt < args.retries:
            print(f"retrying {len(failed)} failed batch(es): {failed}",
                  file=sys.stderr)
            batch_ids = failed
    print(f"batches failed after retries: {failed}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="batch_run")
    p.add_argument("-B", "--batches", type=int, required=True)
    p.add_argument("-j", "--jobs", type=int, default=1,
                   help="concurrent shard processes")
    p.add_argument("--retries", type=int, default=1,
                   help="failed batch retry count (ClusterManager.pm)")
    p.add_argument("--failed-list", default="failed_batches.lst")
    p.add_argument("--submit", choices=["local", "slurm", "condor"],
                   default="local",
                   help="slurm: emit + sbatch an array script "
                        "(submit-to-slurm.sh / ClusterManager.pm); "
                        "condor: condor_submit + condor_wait "
                        "(submit-to-condor.sh)")
    p.add_argument("--sbatch-args", default="",
                   help="extra #SBATCH line; pass with '=' (e.g. "
                        "--sbatch-args='--mem-per-cpu=8G "
                        "--time=4:00:00')")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--dry-run", action="store_true",
                   help="print the generated sbatch script and exit")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command template with {B} and {I}")
    args = p.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        raise SystemExit("batch_run: no command given")
    if args.submit == "slurm":
        return submit_slurm(args, cmd)
    if args.submit == "condor":
        return submit_condor(args, cmd)

    cards = worker_cards(args.jobs)
    pending = list(range(1, args.batches + 1))
    for attempt in range(args.retries + 1):
        failed = []
        running = {}
        free = list(cards)
        queue = list(pending)
        while queue or running:
            while queue and len(running) < args.jobs:
                i = queue.pop(0)
                c = [x.replace("{B}", str(args.batches))
                     .replace("{I}", str(i)) for x in cmd]
                card = free.pop(0) if cards else None
                running[i] = (subprocess.Popen(c, env=worker_env(card)),
                              card)
            done = []
            for i, (proc, card) in running.items():
                rc = proc.poll()
                if rc is not None:
                    done.append(i)
                    if card is not None:
                        free.append(card)
                    if rc != 0:
                        failed.append(i)
                        print(f"batch {i} failed (rc {rc})",
                              file=sys.stderr)
            for i in done:
                del running[i]
            if running:
                import time
                time.sleep(0.2)
        if not failed:
            if os.path.exists(args.failed_list):
                os.remove(args.failed_list)
            return 0
        with open(args.failed_list, "w") as f:
            for i in failed:
                f.write(f"{i}\n")
        if attempt < args.retries:
            print(f"retrying {len(failed)} failed batch(es)",
                  file=sys.stderr)
            pending = failed
    print(f"batches failed after retries: {failed}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
