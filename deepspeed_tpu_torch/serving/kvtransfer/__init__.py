"""KV page export/import for cross-replica migration (docs/SERVING.md
"Disaggregated serving").

Device↔host staging of a request's paged KV state: a crc-tagged
:class:`KVSnapshot` container, a chunked :class:`KVExporter` whose d2h
copies overlap the source replica's ongoing decode steps, and
:func:`import_snapshot` to resume decode on another engine with
byte-identical outputs.  :func:`export_prefix` / :func:`import_prefix`
carry the same machinery for SHARED-PREFIX pages: immutable full pages of
a hot prompt prefix staged once and adopted into a cold replica's prefix
cache (docs/SERVING.md "Prefix directory").  Fault sites ``kv.export`` /
``kv.import`` / ``prefix.import`` wrap the staging edges
(docs/RESILIENCE.md).
"""

from .snapshot import (KVExporter, KVImportError, KVSnapshot, SnapshotAborted,
                       SnapshotError, SnapshotIntegrityError, export_prefix,
                       import_prefix, import_snapshot)

__all__ = [
    "KVExporter", "KVImportError", "KVSnapshot", "SnapshotAborted",
    "SnapshotError", "SnapshotIntegrityError", "export_prefix",
    "import_prefix", "import_snapshot",
]
