"""``tools/profile_train.py``'s stage attribution on made-up traces: a
kernel belongs to the stage whose range holds its launch call, else its
own start on the device, and the port's kernels are told apart by name.
No card: the functions take plain tuples."""

import pytest

from tpu3d_torch.tools.profile_train import (attribute, is_port_kernel,
                                             port_kernel_names)

WINDOWS = [(0.0, 10.0, "rpn_forward"), (20.0, 60.0, "backward"),
           (11.0, 15.0, "loss")]


@pytest.mark.parametrize("kernel,launch,stage,how", [
    ((1, 50.0, 2.0), 1.0, "rpn_forward", "launch"),   # ran after its stage
    ((2, 9.0, 3.0), 25.0, "backward", "launch"),      # launch decides
    ((3, 12.0, 1.0), None, "loss", "device start"),   # no launch call
    ((4, 100.0, 4.0), None, None, "outside"),
    ((5, 3.0, 5.0), 15.5, None, "outside"),           # between two stages
])
def test_attribute_by_launch_then_device_start(kernel, launch, stage, how):
    launches = {} if launch is None else {kernel[0]: launch}
    per_stage, totals = attribute([kernel], launches, WINDOWS)
    assert per_stage == ({} if stage is None else {stage: kernel[2]})
    assert totals[how] == kernel[2]
    assert sum(totals.values()) == kernel[2]


def test_attribute_sums_per_stage():
    kernels = [(i, 30.0 + i, 1.0) for i in range(1, 7)]
    launches = {1: 2.0, 2: 3.0, 3: 12.0}
    per_stage, totals = attribute(kernels, launches, WINDOWS)
    assert per_stage == {"rpn_forward": 2.0, "loss": 1.0, "backward": 3.0}
    assert totals == {"launch": 3.0, "device start": 3.0, "outside": 0.0}


def test_port_kernel_names():
    """Every __global__ of the port's sources is found, and trace names
    match them with or without ``void`` and template arguments; torch's
    own kernels and copies do not."""
    names = port_kernel_names()
    assert {"fps_rows_kernel", "build_kernel", "three_nn_kernel",
            "gather_kernel", "dweight_kernel", "fps_cluster_kernel",
            "nearest_k_kernel", "three_interpolate_kernel"} <= names
    for name in ("(anonymous namespace)::gather_kernel<float4, 2>(float "
                 "const*, float const*, int, int, int, int, int const*, "
                 "int const*, float*)",
                 "void (anonymous namespace)::fps_rows_kernel<1, 16>(float "
                 "const*, int, int, int, int*)",
                 "nearest_k_kernel(float const*)"):
        assert is_port_kernel(name, names), name
    for name in ("void at::native::vectorized_elementwise_kernel<4, "
                 "at::native::FillFunctor<float>>(int, ...)",
                 "void at::native::(anonymous namespace)::build_kernel(int)",
                 "Memset (Device)", "Memcpy HtoD (Pageable -> Device)"):
        assert not is_port_kernel(name, names), name
