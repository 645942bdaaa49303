"""Dataset factory (SURVEY.md §2.1 L7): converters from raw datasets to
the canonical temporal tfrecord schema, offline phi extraction on the
device, and record inspection tools. Counterpart of
``human_dynamics_tpu/datasets``; no module here imports cv2 at import
time."""

from human_dynamics_tpu_torch.datasets.common import (
    encode_jpeg,
    decode_jpeg,
    crop_person,
    clean_tube,
)
from human_dynamics_tpu_torch.datasets.test_records import (
    save_seq_to_test_tfrecord,
)
from human_dynamics_tpu_torch.datasets.phi_extractor import FeatureExtractor
from human_dynamics_tpu_torch.datasets.tube_writer import TubeConverter
