"""Remote blob storage for checkpoints and metrics.

Port of ``mlp_ppo_2ply_p3_tpu/utils/remote.py`` (no framework code, so a
faithful copy): a small store abstraction with three URL schemes —

- ``file:///abs/dir``  local/NFS directory (always available; tests)
- ``s3://bucket/pfx``  via boto3 (gated import)
- ``gs://bucket/pfx``  via google-cloud-storage (gated import)

Upload failures never crash training: every op returns True/False (or
an empty list) and prints the failure.  Directories upload recursively.
"""

from __future__ import annotations

import os
import shutil


class RemoteStore:
    """put/get/list against a base URL; see module docstring."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")
        if base_url.startswith("file://"):
            self.scheme = "file"
            self.root = self.base_url[len("file://"):]
        elif base_url.startswith("s3://"):
            self.scheme = "s3"
            rest = self.base_url[len("s3://"):]
            self.bucket, _, self.prefix = rest.partition("/")
        elif base_url.startswith("gs://"):
            self.scheme = "gs"
            rest = self.base_url[len("gs://"):]
            self.bucket, _, self.prefix = rest.partition("/")
        else:
            raise ValueError(
                f"unsupported remote url {base_url!r} "
                "(file:// | s3:// | gs://)"
            )

    # -- internals -----------------------------------------------------------

    def _client(self):
        if self.scheme == "s3":
            import boto3  # type: ignore

            return boto3.client("s3")
        if self.scheme == "gs":
            from google.cloud import storage  # type: ignore

            return storage.Client().bucket(self.bucket)
        return None

    def _walk_files(self, local_path: str):
        """Yield (abs_file, rel_name) — one entry for plain files."""
        if os.path.isdir(local_path):
            for dirpath, _, files in os.walk(local_path):
                for f in files:
                    p = os.path.join(dirpath, f)
                    yield p, os.path.relpath(p, local_path)
        else:
            yield local_path, ""

    # -- public API ----------------------------------------------------------

    def put(self, local_path: str, remote_name: str) -> bool:
        """Upload a file or directory (recursively).  Never raises."""
        try:
            for abs_f, rel in self._walk_files(local_path):
                name = f"{remote_name}/{rel}" if rel else remote_name
                if self.scheme == "file":
                    dst = os.path.join(self.root, name)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copy2(abs_f, dst)
                elif self.scheme == "s3":
                    key = f"{self.prefix}/{name}" if self.prefix else name
                    self._client().upload_file(abs_f, self.bucket, key)
                else:  # gs
                    blob = self._client().blob(
                        f"{self.prefix}/{name}" if self.prefix else name
                    )
                    blob.upload_from_filename(abs_f)
            return True
        except Exception as e:  # graceful degradation: training goes on
            print(f"remote put({local_path} -> {remote_name}) failed: {e}")
            return False

    def get(self, remote_name: str, local_path: str) -> bool:
        """Download one remote object to a local file.  Never raises."""
        try:
            os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
            if self.scheme == "file":
                shutil.copy2(os.path.join(self.root, remote_name), local_path)
            elif self.scheme == "s3":
                key = (
                    f"{self.prefix}/{remote_name}" if self.prefix
                    else remote_name
                )
                self._client().download_file(self.bucket, key, local_path)
            else:
                blob = self._client().blob(
                    f"{self.prefix}/{remote_name}" if self.prefix
                    else remote_name
                )
                blob.download_to_filename(local_path)
            return True
        except Exception as e:
            print(f"remote get({remote_name}) failed: {e}")
            return False

    def list(self, prefix: str = "") -> list:
        """Remote names under ``prefix`` (empty on failure)."""
        try:
            if self.scheme == "file":
                base = os.path.join(self.root, prefix) if prefix else self.root
                out = []
                for dirpath, _, files in os.walk(base):
                    for f in files:
                        out.append(
                            os.path.relpath(os.path.join(dirpath, f), self.root)
                        )
                return sorted(out)
            if self.scheme == "s3":
                key = f"{self.prefix}/{prefix}" if self.prefix else prefix
                resp = self._client().list_objects_v2(
                    Bucket=self.bucket, Prefix=key
                )
                names = [o["Key"] for o in resp.get("Contents", [])]
                cut = len(self.prefix) + 1 if self.prefix else 0
                return sorted(n[cut:] for n in names)
            blobs = self._client().list_blobs(prefix=(
                f"{self.prefix}/{prefix}" if self.prefix else prefix
            ))
            cut = len(self.prefix) + 1 if self.prefix else 0
            return sorted(b.name[cut:] for b in blobs)
        except Exception as e:
            print(f"remote list({prefix}) failed: {e}")
            return []


def maybe_store(url: str | None):
    """RemoteStore or None for empty/None url."""
    return RemoteStore(url) if url else None
