"""``tests/test_datasets.py``'s 8 cases against the port's carried
``baton_tpu_torch/data/datasets.py``: the on-disk formats written as
fixtures, the synthetic fallback, the tokenizer and the bundled digits.
Only offline paths are reached (``data_dir``, ``fallback="synthetic"``,
``load_digits_real``); nothing downloads."""

from _torch_carried_cases import port_cases

globals().update(port_cases("test_datasets.py", {}))
