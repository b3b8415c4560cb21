"""The device a run measures: synchronization, peak memory, its name."""

import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device):
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()
