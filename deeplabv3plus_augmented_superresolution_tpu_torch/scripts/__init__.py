"""The quality-evidence scripts (port of the JAX repository's ``scripts/``):
``quality_demo`` (a trained model through the full 512-px ASR path),
``ab_stats``, ``per_class_validation``, ``label_map_eval``,
``ab_serving_vs_strict``, ``ab_cg_vs_adam`` and ``make_synthetic_voc``, with
their shared work in ``common``. Each keeps the JAX script's flags and
output keys, adds ``--device`` (``cuda`` by default) and runs with
``python -m deeplabv3plus_augmented_superresolution_tpu_torch.scripts.<name>``.
"""
