"""The 2018-paper Caffe parity stack (counterpart of
ubresnet_tpu/parity): the caffe graph executor, the protobuf walker,
score-file comparison, accuracy evaluation and entry alignment."""
from ubresnet_tpu_torch.parity.compare import compare_score_files, score_diff  # noqa: F401
