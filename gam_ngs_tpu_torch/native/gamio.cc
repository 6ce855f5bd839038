// Native BAM/BGZF decoder -> columnar alignment tables.
//
// C++ replacement for the reference's BamTools stack
// (lib/bamtools-2.3.0/src/api/): BGZF members are
// inflated in parallel (each 64KiB block is an independent gzip
// member), then records are parsed in one pass into flat columns that
// mirror io.bam.AlignmentTable exactly (same end_pos
// semantics, NH/XT tag rules and FNV-1a name hashes as the Python
// oracle decoder).  Exposed with a C ABI for ctypes.

#include <sys/stat.h>
#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Member {
  size_t comp_off;   // offset of the deflate payload
  size_t comp_len;
  size_t out_off;    // offset in the inflated stream
  size_t out_len;    // ISIZE
};

// Parse the BGZF member header at d (with n bytes available); returns
// the total member size (0 when not a valid BGZF member) and sets
// payload_off/comp_len/out_len.  Requires the FULL member in [d, d+n).
size_t parse_member(const uint8_t* d, size_t n, size_t& payload_off,
                    size_t& comp_len, size_t& out_len) {
  if (n < 18 || d[0] != 0x1f || d[1] != 0x8b) return 0;
  uint8_t flg = d[3];
  size_t p = 10;
  size_t bsize = 0;
  if (flg & 4) {  // FEXTRA
    if (p + 2 > n) return 0;
    uint16_t xlen;
    memcpy(&xlen, d + p, 2);
    p += 2;
    size_t xend = p + xlen;
    if (xend > n) return 0;
    while (p + 4 <= xend) {
      uint8_t si1 = d[p], si2 = d[p + 1];
      uint16_t slen;
      memcpy(&slen, d + p + 2, 2);
      p += 4;
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        uint16_t bs;
        memcpy(&bs, d + p, 2);
        bsize = (size_t)bs + 1;
      }
      p += slen;
    }
    p = xend;
  }
  if (bsize == 0 || bsize > n || bsize < p + 8) return 0;
  payload_off = p;
  comp_len = bsize - 8 - p;
  uint32_t isize;
  memcpy(&isize, d + bsize - 4, 4);
  out_len = isize;
  return bsize;
}

// Rolling compressed-input buffer: bounded resident window over a FILE*.
struct StreamBuf {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  uint64_t base = 0;  // file offset of buf[0]
  size_t len = 0;     // valid bytes
  size_t pos = 0;     // scan cursor
  bool eof = false;

  // Try to make avail() grow (compact consumed prefix + fread).
  bool fill() {
    if (eof) return false;
    if (pos > 0) {
      memmove(buf.data(), buf.data() + pos, len - pos);
      base += pos;
      len -= pos;
      pos = 0;
    }
    if (buf.size() < (1u << 20)) buf.resize(1u << 20);
    if (buf.size() - len < (1u << 17)) buf.resize(buf.size() * 2);
    size_t got = fread(buf.data() + len, 1, buf.size() - len, f);
    if (got == 0) {
      eof = true;
      return false;
    }
    len += got;
    return true;
  }
  size_t avail() const { return len - pos; }
};

bool inflate_member(const uint8_t* src, size_t src_len, uint8_t* dst,
                    size_t dst_len) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)src_len;
  zs.next_out = dst;
  zs.avail_out = (uInt)dst_len;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == dst_len;
}

constexpr uint64_t FNV_PRIME = 0x100000001B3ull;

// reference-consuming CIGAR ops: M, D, N, =, X
constexpr uint16_t REF_CONSUME_MASK =
    (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8);

}  // namespace

extern "C" {

struct GamBam {
  int64_t n;
  int32_t* ref_id;
  int32_t* pos;
  int32_t* end_pos;
  uint16_t* flag;
  int32_t* l_seq;
  int32_t* mate_ref_id;
  int32_t* mate_pos;
  int32_t* nh;
  uint8_t* xt;
  uint64_t* name_h1;
  uint64_t* name_h2;
  char* header_text;     // SAM header text (NUL-terminated)
  int32_t n_ref;
  char** ref_names;      // NUL-terminated names
  int32_t* ref_lengths;
  const char* error;     // non-NULL on failure (static string)
};

// Streaming decode: bounded-memory pipeline over (compressed window) ->
// (parallel member inflate) -> (record parse).  Resident memory is the
// rolling compressed buffer (~1-2 MB) + one inflated window (default
// 8 MB) + the columnar output (~45 B/record, no seq/qual kept) — the
// whole compressed file is never resident, unlike BamTools' but like
// its streaming BgzfStream (lib/bamtools-2.3.0 BgzfStream_p.cpp).
//
// ref_lo/ref_hi restrict the decode to records with ref_id in
// [ref_lo, ref_hi) (ref_hi < 0 = no limit).  index_path names a .gidx
// per-reference virtual-offset index (BamStandardIndex_p.cpp's role):
// written after a full scan, used to seek straight to ref_lo's first
// member on ranged decodes so multi-host create inflates only its
// contig shard.
GamBam* gamio_read_bam_range(const char* path, int n_threads,
                             int32_t ref_lo, int32_t ref_hi,
                             const char* index_path,
                             int64_t window_bytes) {
  GamBam* out = (GamBam*)calloc(1, sizeof(GamBam));
  FILE* f = fopen(path, "rb");
  if (!f) {
    out->error = "cannot open file";
    return out;
  }
  // BAM identity fingerprint for the .gidx staleness check: a stale
  // index (BAM regenerated with the same contig set) would seek to
  // wrong virtual offsets — failing loudly at best, silently decoding
  // wrong shard contents at worst.
  int64_t bam_size = 0, bam_mtime = 0;
  {
    struct stat st;
    if (fstat(fileno(f), &st) == 0) {
      bam_size = (int64_t)st.st_size;
      bam_mtime = (int64_t)st.st_mtime;
    }
  }
  if (window_bytes <= 0) window_bytes = 8 << 20;
  int nt = n_threads > 0 ? n_threads : 4;

  StreamBuf in;
  in.f = f;

  std::vector<uint8_t> pending;   // inflated, unparsed bytes
  size_t parse_off = 0;           // cursor within pending
  uint64_t pending_base = 0;      // global inflated offset of pending[0]
  // members still overlapping pending (for voffset mapping)
  struct MemberAt {
    uint64_t out_off;
    uint64_t file_off;
    uint32_t out_len;
  };
  std::vector<MemberAt> live_members;
  uint64_t global_out = 0;  // inflated bytes produced so far

  // One window: scan members until window_bytes inflated, parallel
  // inflate, append to pending.  Returns false at EOF (no more data)
  // or on error (out->error set).
  std::vector<uint8_t> window;
  auto next_window = [&]() -> bool {
    struct Job {
      size_t buf_off;  // payload offset in in.buf (stable this window)
      size_t comp_len;
      size_t out_off;  // offset in window
      size_t out_len;
    };
    std::vector<Job> jobs;
    size_t wsize = 0;
    // Collect fully-resident members; stop at window budget.  fill()
    // memmoves the buffer, so it must never run while jobs hold
    // offsets into it — break out and inflate first instead.
    while ((int64_t)wsize < window_bytes) {
      if (in.avail() < 18) {
        if (!jobs.empty()) break;
        if (!in.fill()) break;
        continue;
      }
      size_t payload_off, comp_len, out_len;
      size_t msize = parse_member(in.buf.data() + in.pos, in.avail(),
                                  payload_off, comp_len, out_len);
      if (msize == 0) {
        if (!jobs.empty()) break;            // inflate, retry next call
        if (!in.eof && in.fill()) continue;  // member may be split
        if (in.avail() > 0) out->error = "not a BGZF stream";
        return false;
      }
      if (out_len > 0) {
        jobs.push_back({in.pos + payload_off, comp_len, wsize, out_len});
        live_members.push_back({global_out, in.base + in.pos,
                                (uint32_t)out_len});
        wsize += out_len;
        global_out += out_len;
      }
      in.pos += msize;
    }
    if (jobs.empty()) {
      if (in.eof && in.avail() > 0) out->error = "not a BGZF stream";
      return false;
    }
    window.resize(wsize);
    int threads_n = (int)std::min((size_t)nt, jobs.size());
    std::vector<std::thread> threads;
    std::vector<int> errs(threads_n, 0);
    for (int t = 0; t < threads_n; ++t) {
      threads.emplace_back([&, t]() {
        for (size_t m = t; m < jobs.size(); m += (size_t)threads_n) {
          if (!inflate_member(in.buf.data() + jobs[m].buf_off,
                              jobs[m].comp_len,
                              window.data() + jobs[m].out_off,
                              jobs[m].out_len))
            errs[t] = 1;
        }
      });
    }
    for (auto& th : threads) th.join();
    for (int e : errs)
      if (e) {
        out->error = "BGZF inflate failed";
        return false;
      }
    // compact pending: drop parsed prefix, append window
    if (parse_off > 0) {
      pending.erase(pending.begin(), pending.begin() + (long)parse_off);
      pending_base += parse_off;
      parse_off = 0;
    }
    pending.insert(pending.end(), window.begin(), window.end());
    // prune member map entries fully before pending_base
    size_t keep = 0;
    while (keep < live_members.size() &&
           live_members[keep].out_off + live_members[keep].out_len <=
               pending_base)
      ++keep;
    if (keep > 0)
      live_members.erase(live_members.begin(),
                         live_members.begin() + (long)keep);
    return true;
  };

  auto voffset_of = [&](uint64_t gpos) -> int64_t {
    // binary search live_members for the member containing gpos
    size_t lo = 0, hi = live_members.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (live_members[mid].out_off + live_members[mid].out_len <= gpos)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo >= live_members.size() || live_members[lo].out_off > gpos)
      return -1;
    return (int64_t)((live_members[lo].file_off << 16) |
                     (gpos - live_members[lo].out_off));
  };

  // ---- header ----
  auto have = [&]() { return pending.size() - parse_off; };
  while (have() < 12)
    if (!next_window()) {
      if (!out->error) out->error = "bad BAM magic";
      fclose(f);
      return out;
    }
  if (memcmp(pending.data() + parse_off, "BAM\x01", 4) != 0) {
    out->error = "bad BAM magic";
    fclose(f);
    return out;
  }
  int32_t l_text;
  memcpy(&l_text, pending.data() + parse_off + 4, 4);
  while (have() < 12 + (size_t)l_text)
    if (!next_window()) {
      out->error = "truncated header";
      fclose(f);
      return out;
    }
  out->header_text = (char*)malloc((size_t)l_text + 1);
  memcpy(out->header_text, pending.data() + parse_off + 8, (size_t)l_text);
  out->header_text[l_text] = 0;
  size_t hoff = parse_off + 8 + (size_t)l_text;
  int32_t n_ref;
  {
    while (have() < (hoff - parse_off) + 4)
      if (!next_window()) {
        out->error = "truncated header";
        fclose(f);
        return out;
      }
    memcpy(&n_ref, pending.data() + hoff, 4);
    hoff += 4;
  }
  out->n_ref = n_ref;
  out->ref_names = (char**)calloc((size_t)n_ref, sizeof(char*));
  out->ref_lengths = (int32_t*)calloc((size_t)n_ref, 4);
  for (int32_t r = 0; r < n_ref; ++r) {
    while (have() < (hoff - parse_off) + 4)
      if (!next_window()) {
        out->error = "truncated header";
        fclose(f);
        return out;
      }
    int32_t l_name;
    memcpy(&l_name, pending.data() + hoff, 4);
    while (have() < (hoff - parse_off) + 8 + (size_t)l_name)
      if (!next_window()) {
        out->error = "truncated header";
        fclose(f);
        return out;
      }
    out->ref_names[r] = (char*)malloc((size_t)l_name);
    memcpy(out->ref_names[r], pending.data() + hoff + 4, (size_t)l_name);
    memcpy(&out->ref_lengths[r], pending.data() + hoff + 4 + (size_t)l_name,
           4);
    hoff += 8 + (size_t)l_name;
  }
  parse_off = hoff;

  // ---- index: load for seek, or build during the scan ----
  bool ranged = ref_lo > 0 || ref_hi >= 0;
  std::vector<int64_t> vindex;
  bool build_index = false;
  if (index_path && index_path[0]) {
    FILE* ix = fopen(index_path, "rb");
    if (ix) {
      char magic[8];
      int64_t isz = -1, imt = -1;
      int32_t inr = -1;
      // GAMGIDX2 embeds the BAM's (size, mtime); any mismatch means
      // the BAM changed since indexing — reject and fall back to the
      // full-scan ranged path (GAMGIDX1 indexes are rejected too).
      if (fread(magic, 1, 8, ix) == 8 &&
          memcmp(magic, "GAMGIDX2", 8) == 0 &&
          fread(&isz, 8, 1, ix) == 1 && isz == bam_size &&
          fread(&imt, 8, 1, ix) == 1 && imt == bam_mtime &&
          fread(&inr, 4, 1, ix) == 1 && inr == n_ref) {
        vindex.resize((size_t)n_ref);
        if (fread(vindex.data(), 8, (size_t)n_ref, ix) != (size_t)n_ref)
          vindex.clear();
      }
      fclose(ix);
    }
    if (vindex.empty() && !ranged) {
      build_index = true;
      vindex.assign((size_t)n_ref, -1);
    }
  }

  if (ranged && !vindex.empty()) {
    // seek straight to the first indexed ref in range
    int32_t hi_ref = ref_hi < 0 ? n_ref : (ref_hi < n_ref ? ref_hi : n_ref);
    int64_t voff = -1;
    for (int32_t r = (ref_lo < 0 ? 0 : ref_lo); r < hi_ref; ++r)
      if (vindex[(size_t)r] >= 0) {
        voff = vindex[(size_t)r];
        break;
      }
    if (voff < 0) {  // no records in range
      fclose(f);
      out->n = 0;
      out->ref_id = (int32_t*)malloc(1);
      out->pos = (int32_t*)malloc(1);
      out->end_pos = (int32_t*)malloc(1);
      out->flag = (uint16_t*)malloc(1);
      out->l_seq = (int32_t*)malloc(1);
      out->mate_ref_id = (int32_t*)malloc(1);
      out->mate_pos = (int32_t*)malloc(1);
      out->nh = (int32_t*)malloc(1);
      out->xt = (uint8_t*)malloc(1);
      out->name_h1 = (uint64_t*)malloc(1);
      out->name_h2 = (uint64_t*)malloc(1);
      return out;
    }
    uint64_t file_off = (uint64_t)voff >> 16;
    size_t skip = (size_t)(voff & 0xFFFF);
    fseek(f, (long)file_off, SEEK_SET);
    in.base = file_off;
    in.len = in.pos = 0;
    in.eof = false;
    pending.clear();
    parse_off = 0;
    pending_base = 0;
    global_out = 0;
    live_members.clear();
    while (have() < skip)
      if (!next_window()) {
        out->error = "bad index seek";
        fclose(f);
        return out;
      }
    parse_off += skip;
  }

  // ---- record pass ----
  struct Cols {
    std::vector<int32_t> ref_id, pos, end_pos, l_seq, mate_ref, mate_pos, nh;
    std::vector<uint16_t> flag;
    std::vector<uint8_t> xt;
    std::vector<uint64_t> h1, h2;
  } c;
  c.ref_id.reserve(1024);

  bool done = false;
  while (!done) {
    const uint8_t* d = pending.data();
    size_t nbytes = pending.size();
    while (true) {
      if (parse_off + 4 > nbytes) break;
      int32_t block_size;
      memcpy(&block_size, d + parse_off, 4);
      size_t base = parse_off + 4;
      size_t rec_end = base + (size_t)block_size;
      if (rec_end > nbytes) break;  // wait for more inflated data
      int32_t ref_id, pos_v, mate_ref, mate_pos, l_seq;
      uint32_t bin_mq_nl, flag_nc;
      memcpy(&ref_id, d + base, 4);
      memcpy(&pos_v, d + base + 4, 4);
      memcpy(&bin_mq_nl, d + base + 8, 4);
      memcpy(&flag_nc, d + base + 12, 4);
      memcpy(&l_seq, d + base + 16, 4);
      memcpy(&mate_ref, d + base + 20, 4);
      memcpy(&mate_pos, d + base + 24, 4);
      uint32_t l_read_name = bin_mq_nl & 0xFF;
      uint32_t n_cigar = flag_nc & 0xFFFF;
      uint16_t flag = (uint16_t)(flag_nc >> 16);
      size_t p = base + 32;

      if (build_index && ref_id >= 0 && ref_id < n_ref &&
          vindex[(size_t)ref_id] < 0)
        vindex[(size_t)ref_id] =
            voffset_of(pending_base + (parse_off - 0));

      bool in_range = (ref_id >= ref_lo) && (ref_hi < 0 || ref_id < ref_hi);
      if (ranged && !build_index && ref_hi >= 0 && ref_id >= ref_hi) {
        done = true;  // coordinate-sorted: nothing further in range
        break;
      }
      if (!in_range) {
        parse_off = rec_end;
        continue;
      }

      uint64_t h1 = 0xCBF29CE484222325ull, h2 = 0x84222325CBF29CE4ull;
      for (uint32_t k = 0; k + 1 < l_read_name; ++k) {  // skip trailing NUL
        uint8_t b = d[p + k];
        h1 = (h1 ^ b) * FNV_PRIME;
        h2 = (h2 ^ (uint64_t)(b + 0x9E)) * FNV_PRIME;  // 9-bit, like oracle
      }
      p += l_read_name;

      int32_t ref_len = 0;
      for (uint32_t k = 0; k < n_cigar; ++k) {
        uint32_t cig;
        memcpy(&cig, d + p + 4 * k, 4);
        if (REF_CONSUME_MASK >> (cig & 0xF) & 1)
          ref_len += (int32_t)(cig >> 4);
      }
      p += 4 * (size_t)n_cigar;
      p += ((size_t)l_seq + 1) / 2 + (size_t)l_seq;

      int32_t nh = 1;
      uint8_t xt = 'U';
      while (p < rec_end) {
        uint8_t t0 = d[p], t1 = d[p + 1], typ = d[p + 2];
        p += 3;
        int64_t val = 0;
        bool has_int = true;
        switch (typ) {
          // A/c/C all read as unsigned byte, matching the Python oracle
          case 'A': case 'c': case 'C': val = d[p]; p += 1; break;
          case 's': { int16_t v; memcpy(&v, d + p, 2); val = v; p += 2;
                      break; }
          case 'S': { uint16_t v; memcpy(&v, d + p, 2); val = v; p += 2;
                      break; }
          case 'i': { int32_t v; memcpy(&v, d + p, 4); val = v; p += 4;
                      break; }
          case 'I': { uint32_t v; memcpy(&v, d + p, 4); val = v; p += 4;
                      break; }
          case 'f': p += 4; has_int = false; break;
          case 'Z': case 'H':
            while (p < rec_end && d[p] != 0) ++p;
            ++p;
            has_int = false;
            break;
          case 'B': {
            uint8_t sub = d[p];
            int32_t cnt;
            memcpy(&cnt, d + p + 1, 4);
            int sz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
            p += 5 + (size_t)cnt * sz;
            has_int = false;
            break;
          }
          default:
            out->error = "bad tag type";
            fclose(f);
            return out;
        }
        if (has_int) {
          if (t0 == 'N' && t1 == 'H') {
            nh = (int32_t)val;
          } else if (t0 == 'X' && t1 == 'T' &&
                     (typ == 'A' || typ == 'c' || typ == 'C')) {
            xt = (uint8_t)val;
          }
        }
      }

      c.ref_id.push_back(ref_id);
      c.pos.push_back(pos_v);
      c.end_pos.push_back(pos_v + ref_len);
      c.flag.push_back(flag);
      c.l_seq.push_back(l_seq);
      c.mate_ref.push_back(mate_ref);
      c.mate_pos.push_back(mate_pos);
      c.nh.push_back(nh);
      c.xt.push_back(xt);
      c.h1.push_back(h1);
      c.h2.push_back(h2);
      parse_off = rec_end;
    }
    if (done) break;
    if (!next_window()) {
      if (out->error) {
        fclose(f);
        return out;
      }
      if (pending.size() - parse_off > 0) {
        out->error = "truncated record";
        fclose(f);
        return out;
      }
      break;
    }
  }
  fclose(f);

  if (build_index) {
    std::string tmp = std::string(index_path) + ".tmp";
    FILE* ix = fopen(tmp.c_str(), "wb");
    if (ix) {
      bool ok = fwrite("GAMGIDX2", 1, 8, ix) == 8 &&
                fwrite(&bam_size, 8, 1, ix) == 1 &&
                fwrite(&bam_mtime, 8, 1, ix) == 1 &&
                fwrite(&n_ref, 4, 1, ix) == 1 &&
                fwrite(vindex.data(), 8, (size_t)n_ref, ix) ==
                    (size_t)n_ref;
      ok = fclose(ix) == 0 && ok;
      if (ok)
        rename(tmp.c_str(), index_path);
      else
        remove(tmp.c_str());
    }
  }

  int64_t nr = (int64_t)c.ref_id.size();
  out->n = nr;
  auto dup = [&](const void* src, size_t bytes) {
    void* m = malloc(bytes ? bytes : 1);
    memcpy(m, src, bytes);
    return m;
  };
  out->ref_id = (int32_t*)dup(c.ref_id.data(), 4 * nr);
  out->pos = (int32_t*)dup(c.pos.data(), 4 * nr);
  out->end_pos = (int32_t*)dup(c.end_pos.data(), 4 * nr);
  out->flag = (uint16_t*)dup(c.flag.data(), 2 * nr);
  out->l_seq = (int32_t*)dup(c.l_seq.data(), 4 * nr);
  out->mate_ref_id = (int32_t*)dup(c.mate_ref.data(), 4 * nr);
  out->mate_pos = (int32_t*)dup(c.mate_pos.data(), 4 * nr);
  out->nh = (int32_t*)dup(c.nh.data(), 4 * nr);
  out->xt = (uint8_t*)dup(c.xt.data(), 1 * nr);
  out->name_h1 = (uint64_t*)dup(c.h1.data(), 8 * nr);
  out->name_h2 = (uint64_t*)dup(c.h2.data(), 8 * nr);
  return out;
}

GamBam* gamio_read_bam(const char* path, int n_threads) {
  // INT32_MIN lower bound keeps the unmapped (ref_id = -1) tail records,
  // matching the Python oracle decoder.
  return gamio_read_bam_range(path, n_threads, INT32_MIN, -1, nullptr, 0);
}

// ---------------------------------------------------------------------------
// Block scan: Read::loadReadsMap + Block::findBlocks over merged streams.
// Mirrors core.blocks.find_blocks (the Python oracle) exactly:
// same first-fit active-list semantics, empty-block seeding quirk,
// retirement order and strand-evidence majority.
// ---------------------------------------------------------------------------

struct GamBlocks {
  int64_t n;
  int32_t* num_reads;
  int32_t* m_ctg;
  int32_t* m_begin;
  int32_t* m_end;
  int64_t* m_brl;
  int32_t* s_ctg;
  uint8_t* s_strand;
  int32_t* s_begin;
  int32_t* s_end;
  int64_t* s_brl;
};

namespace {

struct Key {
  uint64_t h1, h2;
  bool operator==(const Key& o) const { return h1 == o.h1 && h2 == o.h2; }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    return (size_t)(k.h1 ^ (k.h2 * 0x9E3779B97F4A7C15ull));
  }
};

struct MRec {
  int32_t ctg, start, end;
  uint8_t rev;
};

struct ABlock {
  int32_t num_reads = 0;
  int32_t m_ctg = 0, m_begin = 0, m_end = 0;
  int64_t m_brl = 0;
  int32_t s_ctg = 0, s_begin = 0, s_end = 0;
  int64_t s_brl = 0;
  int64_t evid_pos = 0, evid_neg = 0;

  void seed(const MRec& m, int32_t sc, int32_t ss, int32_t se) {
    num_reads = 1;
    m_ctg = m.ctg; m_begin = m.start; m_end = m.end - 1;
    m_brl = m.end - m.start;
    s_ctg = sc; s_begin = ss; s_end = se - 1;
    s_brl = se - ss;
  }

  bool add_reads(const MRec& m, int32_t sc, int32_t ss, int32_t se) {
    if (num_reads == 0) {
      seed(m, sc, ss, se);
      return true;
    }
    int32_t m_end_c = m.end - 1, s_end_c = se - 1;
    if (m_ctg == m.ctg && m_end - m.start + 1 >= 0 &&
        m_end_c - m_begin + 1 >= 0 && s_ctg == sc &&
        s_end - ss + 1 >= 0 && s_end_c - s_begin + 1 >= 0) {
      num_reads += 1;
      m_brl += m.end - m.start;
      s_brl += se - ss;
      if (m.start < m_begin) m_begin = m.start;
      if (ss < s_begin) s_begin = ss;
      if (m_end_c > m_end) m_end = m_end_c;
      if (s_end_c > s_end) s_end = s_end_c;
      return true;
    }
    return false;
  }
};

}  // namespace

GamBlocks* gamio_find_blocks(
    int64_t n_master, const uint64_t* mh1, const uint64_t* mh2,
    const uint8_t* mfirst, const int32_t* mctg, const int32_t* mpos,
    const int32_t* mend, const uint8_t* mrev,
    int64_t n_slave, const uint64_t* sh1, const uint64_t* sh2,
    const uint8_t* sfirst, const int32_t* sctg, const int32_t* spos,
    const int32_t* send, const uint8_t* srev, int32_t min_block_size) {
  std::unordered_map<Key, MRec, KeyHash> map1, map2;
  map1.reserve((size_t)n_master);
  for (int64_t i = 0; i < n_master; ++i) {
    MRec r{mctg[i], mpos[i], mend[i], mrev[i]};
    Key k{mh1[i], mh2[i]};
    if (mfirst[i]) map1[k] = r; else map2[k] = r;
  }

  struct Row {
    int32_t num_reads, m_ctg, m_begin, m_end;
    int64_t m_brl;
    int32_t s_ctg;
    uint8_t s_strand;
    int32_t s_begin, s_end;
    int64_t s_brl;
  };
  std::vector<Row> rows;
  std::vector<ABlock> active;

  auto finalize = [&](const ABlock& b) {
    rows.push_back({b.num_reads, b.m_ctg, b.m_begin, b.m_end, b.m_brl,
                    b.s_ctg,
                    (uint8_t)(b.evid_pos >= b.evid_neg ? '+' : '-'),
                    b.s_begin, b.s_end, b.s_brl});
  };

  for (int64_t i = 0; i < n_slave; ++i) {
    Key k{sh1[i], sh2[i]};
    auto& mp = sfirst[i] ? map1 : map2;
    auto it = mp.find(k);
    if (it == mp.end()) continue;
    const MRec& mrec = it->second;
    int32_t sc = sctg[i], ss = spos[i], se = send[i];
    bool concordant = (mrec.rev != 0) == (srev[i] != 0);

    bool reads_added = false;
    size_t kk = 0;
    while (kk < active.size()) {
      ABlock& blk = active[kk];
      if (blk.add_reads(mrec, sc, ss, se)) {
        reads_added = true;
        if (concordant) blk.evid_pos += 1; else blk.evid_neg += 1;
        break;
      }
      bool out_of_scope = (blk.s_end + 1 < ss) || (blk.s_ctg < sc);
      if (out_of_scope) {
        if (blk.num_reads >= min_block_size) finalize(blk);
        active.erase(active.begin() + kk);
        continue;
      }
      ++kk;
    }

    if (!reads_added) {
      ABlock blk;
      if (mrec.end - mrec.start >= min_block_size &&
          se - ss >= min_block_size)
        blk.seed(mrec, sc, ss, se);
      active.push_back(blk);
    }
  }
  for (const ABlock& blk : active)
    if (blk.num_reads >= min_block_size) finalize(blk);

  GamBlocks* out = (GamBlocks*)calloc(1, sizeof(GamBlocks));
  int64_t n = (int64_t)rows.size();
  out->n = n;
  out->num_reads = (int32_t*)malloc(4 * (size_t)n + 1);
  out->m_ctg = (int32_t*)malloc(4 * (size_t)n + 1);
  out->m_begin = (int32_t*)malloc(4 * (size_t)n + 1);
  out->m_end = (int32_t*)malloc(4 * (size_t)n + 1);
  out->m_brl = (int64_t*)malloc(8 * (size_t)n + 1);
  out->s_ctg = (int32_t*)malloc(4 * (size_t)n + 1);
  out->s_strand = (uint8_t*)malloc((size_t)n + 1);
  out->s_begin = (int32_t*)malloc(4 * (size_t)n + 1);
  out->s_end = (int32_t*)malloc(4 * (size_t)n + 1);
  out->s_brl = (int64_t*)malloc(8 * (size_t)n + 1);
  for (int64_t i = 0; i < n; ++i) {
    out->num_reads[i] = rows[i].num_reads;
    out->m_ctg[i] = rows[i].m_ctg;
    out->m_begin[i] = rows[i].m_begin;
    out->m_end[i] = rows[i].m_end;
    out->m_brl[i] = rows[i].m_brl;
    out->s_ctg[i] = rows[i].s_ctg;
    out->s_strand[i] = rows[i].s_strand;
    out->s_begin[i] = rows[i].s_begin;
    out->s_end[i] = rows[i].s_end;
    out->s_brl[i] = rows[i].s_brl;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Banded-SW traceback walk over a direction matrix.
// Mirrors ops.bsw_host._traceback_from_dirs exactly.
// dirs layout: packed=0 -> dense uint8 (XW, YP) row-major for one
// problem; packed=1 -> int32 planes (XW/16, YP): row i's code is
// (plane[i>>4][j] >> ((i & 15) * 2)) & 3.
// Edit codes: GAP_A=0, GAP_B=1, MATCH=2, MISMATCH=3 (editops.py).
// Returns the number of edits written into out_edits (caller provides
// a buffer of at least 2 * (XW + YS) bytes), plus matches/x/pos via
// out parameters.  Edits are written in REVERSE walk order; the caller
// reverses (same as the Python implementation's final reverse).
// ---------------------------------------------------------------------------

int64_t gamio_traceback(const void* dirs, int32_t packed, int64_t dirs_stride,
                        int32_t band, int32_t max_i, int32_t max_j,
                        int32_t begin_a, int32_t begin_b,
                        const uint8_t* a, int64_t a_len,
                        const uint8_t* b, int64_t b_len,
                        uint8_t* out_edits, int64_t out_cap,
                        int64_t* out_matches, int32_t* out_x,
                        int32_t* out_pos) {
  (void)a_len;
  (void)b_len;
  int32_t x = max_i, y = max_j;
  int32_t pos = begin_a + x + y - band;
  int64_t n = 0, matches = 0;
  const uint8_t* d8 = (const uint8_t*)dirs;
  const int32_t* d32 = (const int32_t*)dirs;
  while (x >= 0 && y >= 0 && pos >= 0 && n < out_cap) {
    int32_t dcode;
    if (packed)
      dcode = (d32[(int64_t)(x >> 4) * dirs_stride + y] >> ((x & 15) * 2)) & 3;
    else
      dcode = d8[(int64_t)x * dirs_stride + y];
    if (dcode == 0) {  // diag
      uint8_t ca = a[pos], cb = b[begin_b + x];
      if (ca == cb || ca == 4 || cb == 4) {
        out_edits[n++] = 2;  // MATCH
        ++matches;
      } else {
        out_edits[n++] = 3;  // MISMATCH
      }
      --x;
    } else if (dcode == 1) {  // up
      out_edits[n++] = 0;  // GAP_A
      --x;
      ++y;
    } else {  // left
      out_edits[n++] = 1;  // GAP_B
      --y;
    }
    pos = begin_a + x + y - band;
  }
  *out_matches = matches;
  *out_x = x;
  *out_pos = pos;
  return n;
}

// ---------------------------------------------------------------------------
// Sequential Welford insert-size stats, bit-identical to the reference's
// streaming update (MultiBamReader.cc:346-429): count starts at 1 and the
// final std divides M2 by the FINAL count (n_samples + 1).  Same float64
// operation order as core/stats.py::welford_isize_stats, so the native
// and Python paths agree to the last bit.
// ---------------------------------------------------------------------------

void gamio_welford(const int64_t* x, int64_t n, double* out_mean,
                   double* out_std) {
  int64_t count = 1;
  double mean = 0.0, m2 = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    double v = (double)x[i];
    if (count == 1) {
      mean = v;
      m2 = 0.0;
      ++count;
    } else {
      double old_mean = mean;
      mean = old_mean + (v - old_mean) / (double)count;
      m2 = m2 + (double)(count - 1) * (v - old_mean) * (v - old_mean) /
                    (double)count;
      ++count;
    }
  }
  *out_mean = mean;
  *out_std = sqrt(m2 / (double)count);
}

void gamio_free_blocks(GamBlocks* b) {
  if (!b) return;
  free(b->num_reads); free(b->m_ctg); free(b->m_begin); free(b->m_end);
  free(b->m_brl); free(b->s_ctg); free(b->s_strand); free(b->s_begin);
  free(b->s_end); free(b->s_brl);
  free(b);
}

void gamio_free(GamBam* b) {
  if (!b) return;
  free(b->ref_id); free(b->pos); free(b->end_pos); free(b->flag);
  free(b->l_seq); free(b->mate_ref_id); free(b->mate_pos); free(b->nh);
  free(b->xt); free(b->name_h1); free(b->name_h2);
  free(b->header_text);
  if (b->ref_names) {
    for (int32_t r = 0; r < b->n_ref; ++r) free(b->ref_names[r]);
    free(b->ref_names);
  }
  free(b->ref_lengths);
  free(b);
}

}  // extern "C"
