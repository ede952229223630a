// Native tar shard indexer + positional reader for the data pipeline
// (the port's copy of aki_tpu/native/tar_index.cpp, the same C ABI).
//
// The reference's data path is pure Python streaming over tarfile
// (train/data_utils.py); the input pipeline must keep up with the
// accelerator, so this module provides:
//
//   - one-pass O(headers) indexing of a tar shard (name, offset, size per
//     regular file member, USTAR prefix + GNU longname support);
//   - pread()-based positional reads that run outside the Python GIL
//     (ctypes releases it during the call), enabling genuinely parallel
//     sample fetch + JPEG decode across worker threads.
//
// Plain C ABI so Python binds with ctypes (no pybind11 needed);
// aki_torch/data/native_tar.py builds it with g++ at first use.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Entry {
  std::string name;
  uint64_t offset;   // offset of file DATA (past the header)
  uint64_t size;
};

struct TarIndex {
  int fd = -1;
  std::vector<Entry> entries;
};

uint64_t parse_octal(const char* p, size_t n) {
  uint64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = (v << 3) | static_cast<uint64_t>(p[i] - '0');
  }
  return v;
}

bool is_zero_block(const char* b) {
  for (int i = 0; i < 512; ++i)
    if (b[i]) return false;
  return true;
}

}  // namespace

extern "C" {

// Returns an opaque handle or nullptr on failure.
void* tar_index_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;

  auto* idx = new TarIndex();
  idx->fd = fd;

  char block[512];
  uint64_t pos = 0;
  std::string pending_longname;
  int zero_blocks = 0;

  while (true) {
    ssize_t r = ::pread(fd, block, 512, static_cast<off_t>(pos));
    if (r < 512) break;  // truncated tail: keep what we have
    if (is_zero_block(block)) {
      if (++zero_blocks >= 2) break;
      pos += 512;
      continue;
    }
    zero_blocks = 0;

    uint64_t size = parse_octal(block + 124, 12);
    char type = block[156];
    uint64_t data = pos + 512;
    uint64_t padded = (size + 511) & ~uint64_t(511);

    if (type == 'L') {  // GNU long name: payload is the next member's name
      std::vector<char> nb(size + 1, 0);
      if (::pread(fd, nb.data(), size, static_cast<off_t>(data)) ==
          static_cast<ssize_t>(size)) {
        pending_longname.assign(nb.data());
      }
    } else if (type == '0' || type == '\0') {  // regular file
      std::string name;
      if (!pending_longname.empty()) {
        name = pending_longname;
        pending_longname.clear();
      } else {
        char nbuf[101] = {0};
        std::memcpy(nbuf, block, 100);
        name.assign(nbuf);
        if (block[345]) {  // USTAR prefix
          char pbuf[156] = {0};
          std::memcpy(pbuf, block + 345, 155);
          name = std::string(pbuf) + "/" + name;
        }
      }
      idx->entries.push_back(Entry{std::move(name), data, size});
    } else {
      pending_longname.clear();
    }
    pos = data + padded;
  }
  return idx;
}

int64_t tar_index_count(void* handle) {
  if (!handle) return -1;
  return static_cast<int64_t>(static_cast<TarIndex*>(handle)->entries.size());
}

// Copies the i-th entry's name into name_buf (cap bytes incl. NUL) and
// writes offset/size. Returns 0 on success.
int tar_index_entry(void* handle, int64_t i, char* name_buf, int64_t cap,
                    uint64_t* offset, uint64_t* size) {
  if (!handle) return -1;
  auto* idx = static_cast<TarIndex*>(handle);
  if (i < 0 || i >= static_cast<int64_t>(idx->entries.size())) return -2;
  const Entry& e = idx->entries[static_cast<size_t>(i)];
  std::snprintf(name_buf, static_cast<size_t>(cap), "%s", e.name.c_str());
  *offset = e.offset;
  *size = e.size;
  return 0;
}

// Positional read of [offset, offset+size) into out. Returns bytes read.
int64_t tar_index_read(void* handle, uint64_t offset, uint64_t size,
                       uint8_t* out) {
  if (!handle) return -1;
  auto* idx = static_cast<TarIndex*>(handle);
  uint64_t done = 0;
  while (done < size) {
    ssize_t r = ::pread(idx->fd, out + done, size - done,
                        static_cast<off_t>(offset + done));
    if (r <= 0) break;
    done += static_cast<uint64_t>(r);
  }
  return static_cast<int64_t>(done);
}

void tar_index_close(void* handle) {
  if (!handle) return;
  auto* idx = static_cast<TarIndex*>(handle);
  if (idx->fd >= 0) ::close(idx->fd);
  delete idx;
}

}  // extern "C"
