"""Fixture: TEL001. Reference counterpart: none — lint fixture."""
import json


class Recorder:
    def _emit(self, record):
        self._fh.write(json.dumps(record) + "\n")  # VIOLATION: per-span I/O

    def flush(self):
        pass
