"""Fixture: IMP001. Reference counterpart: none — lint fixture."""
import json
import torch  # VIOLATION: module-scope torch in a torch-free-contracted file


class Recorder:
    def snapshot(self):
        return json.dumps({"cuda": torch.cuda.is_available()})
