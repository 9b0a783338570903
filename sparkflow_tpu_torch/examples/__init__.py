"""The port's examples: one module per user-facing example of the JAX
package's ``examples/``, with the same model, Estimator Params, optimizer
settings, synthetic data and printed lines, run on the H100.

Each module has ``run(*, device="cuda", smoke=False, workdir=None, ...)``,
which returns a dict of what it printed (losses, accuracy, rows or tokens a
second, paths), and ``main(argv=None)``::

    python -m sparkflow_tpu_torch.examples.simple_dnn            # on the card
    python -m sparkflow_tpu_torch.examples.simple_dnn --device cpu --smoke

Without a card they raise unless given ``--device cpu``; nothing falls back
to the CPU. Saved pipelines go into ``workdir`` (a new temporary directory
when none is given), never into the current directory. ``--smoke`` takes
the small sizes of the JAX examples' smoke mode.

- ``simple_dnn``, ``cnn_example``, ``autoencoder_example``: the reference
  sparkflow's three MNIST examples through ``Pipeline.fit``;
- ``bert_classifier``, ``text_classifier``: transformer classifiers through
  ``SparkAsyncDL`` (the flash-attention kernels' training path);
- ``serving_example``, ``quantized_serving``, ``streaming_example``: HTTP
  serving, int8 serving and streaming training;
- ``rnn_sequence``, ``resnet_cifar``: the recurrent and ResNet families;
- ``tf1_migration``: a TF1 MetaGraphDef and Saver checkpoint, unchanged;
- ``long_context_lm``: ring-attention sequence parallelism on two ranks.
"""
