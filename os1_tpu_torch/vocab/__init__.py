"""Place recognition: the BoW vocabulary, its DBoW2 binary format and the
keyframe database (see os1_tpu/vocab)."""
