"""Job submission: run driver scripts against a live cluster.

Reference parity: dashboard/modules/job/job_manager.py:60 (JobManager
.submit_job), job_supervisor.py:55 (per-job supervisor tailing the driver),
and the job table half of GcsJobManager (gcs_job_manager.h:52).

Design differences, by design: the reference runs a supervisor *actor* per
job whose node placement the scheduler picks; here jobs are head-host
subprocesses supervised by a watcher thread — on a TPU pod the head host
drives and the scheduler places *work*, not drivers (SURVEY.md §7
inversion). The submitted entrypoint connects back as a driver client
(``ray_tpu_torch.init(address="auto")``) through the cluster file the runtime
exports, exactly like a reference job driver dialing its cluster's GCS.
"""
from __future__ import annotations

import os
import shlex
import subprocess
import threading
import time

# terminal states (reference: JobStatus in job/common.py)
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"


class JobInfo:
    def __init__(self, job_id: str, entrypoint: str, log_path: str,
                 metadata: dict | None = None):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.status = PENDING
        self.message = ""
        self.start_time = time.time()
        self.end_time: float | None = None
        self.log_path = log_path
        self.metadata = metadata or {}
        self.pid: int | None = None

    def to_dict(self) -> dict:
        return {"job_id": self.job_id, "entrypoint": self.entrypoint,
                "status": self.status, "message": self.message,
                "start_time": self.start_time, "end_time": self.end_time,
                "metadata": dict(self.metadata), "pid": self.pid}


class JobManager:
    """Head-side job table + driver-subprocess supervision."""

    def __init__(self, session_dir: str, cluster_file: str):
        self.jobs_dir = os.path.join(session_dir, "jobs")
        os.makedirs(self.jobs_dir, exist_ok=True)
        self.cluster_file = cluster_file
        self.lock = threading.Lock()
        self.jobs: dict[str, JobInfo] = {}
        self._procs: dict[str, subprocess.Popen] = {}
        self._seq = 0
        # status-change hook (the head wires this to its pubsub "jobs"
        # channel); called outside self.lock
        self.on_status = lambda job_id, status: None

    def submit(self, entrypoint: str, env: dict | None = None,
               working_dir_zip: bytes | None = None,
               metadata: dict | None = None,
               job_id: str | None = None) -> str:
        # reserve the id + table entry under the lock; do filesystem work
        # (zip extraction, process spawn) outside it so concurrent job RPCs
        # aren't stalled behind a large working_dir
        with self.lock:
            if job_id is None:
                self._seq += 1
                job_id = f"job-{self._seq:05d}"
            elif job_id in self.jobs:
                raise ValueError(f"job id {job_id!r} already exists")
            job_dir = os.path.join(self.jobs_dir, job_id)
            log_path = os.path.join(job_dir, "driver.log")
            info = JobInfo(job_id, entrypoint, log_path, metadata)
            self.jobs[job_id] = info
        try:
            os.makedirs(job_dir, exist_ok=True)
            cwd = os.getcwd()
            if working_dir_zip is not None:
                # _safe_extract creates the dir (atomically; it no-ops on
                # an existing one, so don't pre-create it)
                cwd = os.path.join(job_dir, "working_dir")
                _safe_extract(working_dir_zip, cwd)
        except (OSError, ValueError) as e:
            with self.lock:
                info.status = FAILED
                info.message = f"working_dir setup failed: {e}"
                info.end_time = time.time()
            return job_id

        penv = dict(os.environ)
        penv.update(env or {})
        penv["RTPU_ADDRESS"] = self.cluster_file
        penv["RTPU_JOB_ID"] = job_id
        # the framework isn't pip-installed; make `import ray_tpu_torch` work
        # in the driver regardless of its cwd (reference relies on ray
        # being installed in the job's interpreter)
        fw_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        paths = [fw_root]
        if working_dir_zip is not None:
            # the extracted dir is the job's import root, like the
            # reference's working_dir runtime env
            paths.insert(0, cwd)
        if penv.get("PYTHONPATH"):
            paths.append(penv["PYTHONPATH"])
        penv["PYTHONPATH"] = os.pathsep.join(paths)
        log_f = open(log_path, "wb", buffering=0)
        try:
            proc = subprocess.Popen(
                shlex.split(entrypoint), cwd=cwd, env=penv,
                stdout=log_f, stderr=subprocess.STDOUT,
                start_new_session=True)
        except OSError as e:
            with self.lock:
                info.status = FAILED
                info.message = f"failed to start: {e}"
                info.end_time = time.time()
            log_f.close()
            return job_id
        log_f.close()  # the child holds its own fd now
        with self.lock:
            if info.status == STOPPED:  # stop() raced the spawn
                stopped = True
            else:
                stopped = False
                info.status = RUNNING
                info.pid = proc.pid
                self._procs[job_id] = proc
        if stopped:
            try:
                os.killpg(os.getpgid(proc.pid), 15)
            except (ProcessLookupError, PermissionError):
                pass
            return job_id
        self.on_status(job_id, RUNNING)
        threading.Thread(target=self._watch, args=(job_id, proc),
                         daemon=True, name=f"rtpu-job-{job_id}").start()
        return job_id

    def _watch(self, job_id: str, proc: subprocess.Popen):
        rc = proc.wait()
        with self.lock:
            info = self.jobs.get(job_id)
            self._procs.pop(job_id, None)
            if info is None or info.status == STOPPED:
                return
            info.end_time = time.time()
            if rc == 0:
                info.status = SUCCEEDED
            else:
                info.status = FAILED
                info.message = f"driver exited with code {rc}"
            status = info.status
        self.on_status(job_id, status)

    def stop(self, job_id: str) -> bool:
        with self.lock:
            info = self.jobs.get(job_id)
            if info is None:
                raise ValueError(f"no job {job_id!r}")
            proc = self._procs.get(job_id)
            if proc is None:
                return False
            info.status = STOPPED
            info.message = "stopped by user"
            info.end_time = time.time()
        self.on_status(job_id, STOPPED)
        try:
            # the whole session group: the driver may have forked
            os.killpg(os.getpgid(proc.pid), 15)
        except (ProcessLookupError, PermissionError):
            pass
        return True

    def status(self, job_id: str) -> dict:
        with self.lock:
            info = self.jobs.get(job_id)
            if info is None:
                raise ValueError(f"no job {job_id!r}")
            return info.to_dict()

    def list(self) -> list[dict]:
        with self.lock:
            return [j.to_dict() for j in self.jobs.values()]

    def logs(self, job_id: str, tail_bytes: int = 1 << 20,
             offset: int | None = None) -> str:
        """Driver log: last ``tail_bytes``, or — when ``offset`` is given —
        everything from that byte onward (cursor-based streaming for
        `job logs --follow`, unbounded by the tail window)."""
        with self.lock:
            info = self.jobs.get(job_id)
            if info is None:
                raise ValueError(f"no job {job_id!r}")
            path = info.log_path
        try:
            with open(path, "rb") as f:
                if offset is not None:
                    f.seek(max(0, offset))
                else:
                    f.seek(0, os.SEEK_END)
                    f.seek(max(0, f.tell() - tail_bytes))
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def import_record(self, rec: dict) -> JobInfo | None:
        """Adopt a job row from a previous session's snapshot (gcs_store
        restore). RUNNING/PENDING become FAILED — their driver processes
        died with the old head."""
        with self.lock:
            job_id = rec.get("job_id")
            if not job_id or job_id in self.jobs:
                return None
            info = JobInfo(job_id, rec.get("entrypoint", ""),
                           rec.get("log_path", ""), rec.get("metadata"))
            info.status = rec.get("status", FAILED)
            info.message = rec.get("message", "")
            info.start_time = rec.get("start_time", 0.0)
            info.end_time = rec.get("end_time")
            if info.status in (PENDING, RUNNING):
                info.status = FAILED
                info.message = "head restarted while job was running"
                info.end_time = info.end_time or time.time()
            self.jobs[job_id] = info
            # keep new ids past imported ones
            try:
                n = int(job_id.rsplit("-", 1)[1])
                self._seq = max(self._seq, n)
            except (IndexError, ValueError):
                pass
            return info

    def shutdown(self):
        with self.lock:
            procs = dict(self._procs)
        for job_id, proc in procs.items():
            try:
                os.killpg(os.getpgid(proc.pid), 15)
            except (ProcessLookupError, PermissionError):
                pass


def pack_working_dir(path: str) -> bytes:
    """Zip a directory for submission (reference: working_dir upload to the
    GCS KV store, _private/runtime_env/working_dir.py). One packer serves
    jobs and runtime envs — see runtime_env._zip_path."""
    from .runtime_env import _zip_path
    return _zip_path(path)


def _safe_extract(zip_bytes: bytes, dest: str) -> None:
    """Extract with zip-slip protection (shared impl:
    runtime_env._extract)."""
    from .runtime_env import _extract
    _extract(zip_bytes, dest)
