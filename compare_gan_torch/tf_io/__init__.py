"""TensorFlow's on-disk formats, read and written without TensorFlow.

* `protobuf`: the protobuf wire format, with typed readers for
  `tf.train.Example`, `GraphDef` (Const tensors), `TensorProto`,
  `TensorShapeProto` and the checkpoint bundle's header and entries, and the
  encoders the writers here need.
* `tfrecord`: the TFRecord framing with its masked CRC32C (write; the
  readers are `datasets._py_iter_tfrecords` and the native library).
* `image_codec`: what `tf.io.decode_image` returns for PNG (numpy and zlib)
  and JPEG (a host C++ decoder, `csrc/image_decode.cc`, that follows
  libjpeg's fast integer IDCT, fancy upsampling and YCbCr tables).
* `checkpoint_bundle`: TF V2 checkpoints (`.index` table, `.data-*`
  shards, the `checkpoint` pointer), read and written.

Nothing here imports tensorflow, PIL or google.protobuf.
"""
