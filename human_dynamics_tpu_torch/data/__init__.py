from human_dynamics_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    read_tfrecord,
    encode_example,
    decode_example,
)
from human_dynamics_tpu_torch.data.schema import (
    TemporalExample,
    convert_to_example_temporal,
    parse_temporal_example,
    read_test_example,
)
