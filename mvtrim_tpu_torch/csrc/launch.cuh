// Host-side helpers the C entry points share: launch on the caller's
// device, and the card's attributes read once a device.

#pragma once

#include <atomic>

#include <cuda_runtime.h>

namespace mvt {

constexpr int kMaxDevices = 64;

// Makes `device` current for the guard's life, only where it is not current
// already, and puts the caller's device back after; error() is what the
// switch returned.
class DeviceGuard {
 public:
    explicit DeviceGuard(int device) {
        int current = 0;
        err_ = cudaGetDevice(&current);
        if (err_ == cudaSuccess && current != device) {
            err_ = cudaSetDevice(device);
            if (err_ == cudaSuccess) previous_ = current;
        }
    }
    ~DeviceGuard() {
        if (previous_ >= 0) cudaSetDevice(previous_);
    }
    DeviceGuard(const DeviceGuard&) = delete;
    DeviceGuard& operator=(const DeviceGuard&) = delete;
    cudaError_t error() const { return err_; }

 private:
    int previous_ = -1;
    cudaError_t err_;
};

// An attribute of `device`, asked of the CUDA runtime the first time only.
template <cudaDeviceAttr kAttr>
cudaError_t device_attribute(int device, int* value) {
    static std::atomic<int> cache[kMaxDevices];  // 0: not read yet
    const bool cached = device >= 0 && device < kMaxDevices;
    if (cached) {
        const int v = cache[device].load(std::memory_order_relaxed);
        if (v != 0) {
            *value = v;
            return cudaSuccess;
        }
    }
    const cudaError_t err = cudaDeviceGetAttribute(value, kAttr, device);
    if (err == cudaSuccess && cached)
        cache[device].store(*value, std::memory_order_relaxed);
    return err;
}

}  // namespace mvt
