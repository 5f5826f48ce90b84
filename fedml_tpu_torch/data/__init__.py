"""Federated dataset loaders of the port (counterpart of
``fedml_tpu/data``).

Every loader returns the reference's 8-tuple

    [train_data_num, test_data_num, train_data_global, test_data_global,
     train_data_local_num_dict, train_data_local_dict, test_data_local_dict,
     class_num]

with global and local data as ``{"x": np.ndarray, "y": np.ndarray}``
dicts; the round places them on the device.
"""

from fedml_tpu_torch.data.synthetic import load_synthetic_federated  # noqa: F401
from fedml_tpu_torch.data.registry import load_dataset  # noqa: F401
