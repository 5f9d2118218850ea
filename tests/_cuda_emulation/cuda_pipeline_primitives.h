// Host-compiler stand-in for CUDA's cp.async primitives (see __init__.py).
// Each thread queues its copies; __pipeline_commit() closes a group, and
// __pipeline_wait_prior(n) performs every group but the newest n.  A copy
// therefore lands only when the kernel waits for it, so a kernel that reads
// a slot before its wait reads stale data here as it could on the card.
#pragma once

#include <stddef.h>

void __pipeline_memcpy_async(void* dst, const void* src, size_t size_and_align,
                             size_t zfill = 0);
void __pipeline_commit();
void __pipeline_wait_prior(size_t prior);
