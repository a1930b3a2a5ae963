// Disk-backed state/trace log of the host engines: an append-only file
// of fixed records
//
//     record := packed_state(u32 x row_words) | parent_gid(i64) | action(i32)
//
// written with pwrite and read with pread, so appends (a flush) and
// random reads (a trace walk, a resume) interleave with no seek
// bookkeeping.  A plain C interface loaded with ctypes
// (engine/statelog.py); the record count lives on the Python side.
// Every function returns 0 or a negative errno.

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>

namespace {

int write_all(int fd, const char* buf, int64_t len, off_t off) {
    int64_t done = 0;
    while (done < len) {
        ssize_t w = ::pwrite(fd, buf + done, len - done, off + done);
        if (w < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        done += w;
    }
    return 0;
}

}  // namespace

extern "C" {

// Opens (creating) ``path``; *fd_out the descriptor, *n_rows the
// records already in it.  -EINVAL when its size is not a whole number
// of records.
int ptt_ls_open(const char* path, int64_t rec_size, int* fd_out,
                int64_t* n_rows) {
    int fd = ::open(path, O_RDWR | O_CREAT, 0644);
    if (fd < 0) return -errno;
    off_t end = ::lseek(fd, 0, SEEK_END);
    if (end < 0 || end % rec_size != 0) {
        int err = end < 0 ? -errno : -EINVAL;
        ::close(fd);
        return err;
    }
    *fd_out = fd;
    *n_rows = end / rec_size;
    return 0;
}

// Appends ``n`` records at record ``first``, interleaving the three
// column buffers into one write.
int ptt_ls_append(int fd, int64_t first, int64_t row_words,
                  const char* packed, const char* parents,
                  const char* actions, int64_t n) {
    const int64_t rw4 = row_words * 4;
    const int64_t rec = rw4 + 12;
    char* buf = static_cast<char*>(std::malloc(n * rec > 0 ? n * rec : 1));
    if (!buf) return -ENOMEM;
    for (int64_t i = 0; i < n; i++) {
        char* dst = buf + i * rec;
        std::memcpy(dst, packed + i * rw4, rw4);
        std::memcpy(dst + rw4, parents + i * 8, 8);
        std::memcpy(dst + rw4 + 8, actions + i * 4, 4);
    }
    int rc = write_all(fd, buf, n * rec, static_cast<off_t>(first) * rec);
    std::free(buf);
    return rc;
}

// Reads record ``gid`` into ``out`` (rec_size bytes); -ENODATA on a
// short read.
int ptt_ls_get(int fd, int64_t gid, int64_t rec_size, char* out) {
    int64_t done = 0;
    const off_t off = static_cast<off_t>(gid) * rec_size;
    while (done < rec_size) {
        ssize_t r = ::pread(fd, out + done, rec_size - done, off + done);
        if (r < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        if (r == 0) return -ENODATA;
        done += r;
    }
    return 0;
}

int ptt_ls_sync(int fd) { return ::fsync(fd) < 0 ? -errno : 0; }

int ptt_ls_close(int fd) { return ::close(fd) < 0 ? -errno : 0; }

}  // extern "C"
