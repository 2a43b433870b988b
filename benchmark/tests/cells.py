"""The manifest's training cells."""
import os

from benchmark import harness

ROOT = os.path.dirname(harness.PACKAGE_DIR)


def training_cells(root: str = ROOT) -> list:
    """The cells whose traffic is of the `train` kind, in the manifest's
    order."""
    return [w["name"] for w in harness.load_manifest(root)["workloads"]
            if harness.data_file(root, "workloads",
                                 w["traffic"])["kind"] == "train"]
